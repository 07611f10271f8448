"""K3: fused windowed rel-pos attention (wrapper of `csrc/rel_attention.cu`).

Replaces `rvc_tpu/ops/pallas/attention.py : fused_rel_attention`; the
TextEncoder's attention calls it. For a CPU tensor it runs the plain
version, `rel_attention_reference` (`ops.attention.relative_attention_xla`
with the key-mask outer product); for a CUDA tensor it launches the kernel
or raises. As on the TPU, query rows at or past a sequence's length
differ between the two on purpose (the plain version softmaxes a fully
masked row to uniform, the kernel attends over the valid keys): both are
garbage rows that every caller multiplies away.

On the card one call is three launches: q, k and v copied to contiguous
rows together (`torch.stack`; the TextEncoder's head views of its 1x1
convs' (B, C, T) output have stride T over D, and on the card this copy
costs less than strided loads inside the kernel), the split kernel (scale,
band logits, scores, online softmax, P V, over a share of the keys) and
the merge (log-sum-exp over the key splits, the band weights times
`emb_rel_v`). The output is (B, H, T, D) over (B, T, H, D) memory, which
the caller's `transpose(1, 2).reshape(B, T, C)` takes without a copy.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from rvc_tpu_torch.ops.attention import relative_attention_xla
from rvc_tpu_torch.ops.commons import sequence_mask
from rvc_tpu_torch.ops.kernels import LAUNCHES, build, recorded

HEAD_DIMS = (32, 64, 96, 128)
MAX_WINDOW = 15          # 2w + 1 <= 31


@functools.cache
def _lib():
    """The kernel's C entries, with their ctypes signatures set once."""
    lib = build.load("rel_attention")
    plan = lib.rvc_rel_attention_plan
    plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    plan.restype = ctypes.c_int
    run = lib.rvc_rel_attention
    run.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2
    run.restype = ctypes.c_int
    return plan, run


@functools.cache
def launch_plan(bh: int, T: int, D: int, w: int) -> dict:
    """The split kernel's grid for B*H heads of T rows: key splits, blocks,
    blocks an SM, SMs, shared bytes a block, and waves (blocks over the
    card's block slots)."""
    buf = (ctypes.c_int * 5)()
    build.check(_lib()[0](bh, T, D, w, buf), "rel_attention plan")
    splits, blocks, per_sm, sms, smem = buf
    return dict(splits=splits, blocks=blocks, blocks_per_sm=per_sm, sms=sms,
                smem_bytes=smem, waves=blocks / (per_sm * sms))


def rel_attention_reference(q, k, v, emb_rel_k, emb_rel_v, window_size: int,
                            key_lens: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: the skew formulation with the key-mask outer
    product (a fully masked query row softmaxes to uniform)."""
    km = sequence_mask(key_lens, q.shape[2])
    attn_mask = km[:, None, None, :] * km[:, None, :, None]
    return relative_attention_xla(q, k, v, emb_rel_k, emb_rel_v, window_size, attn_mask)


@recorded
def rel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  emb_rel_k: torch.Tensor, emb_rel_v: torch.Tensor,
                  window_size: int, key_lens: torch.Tensor) -> torch.Tensor:
    """q/k/v (B, H, T, D); emb_rel_* (1 | H, 2w+1, D); key_lens (B,) int ->
    (B, H, T, D). Query rows at or past a length are garbage."""
    B, H, T, D = q.shape
    w = window_size
    if q.device.type == "cpu":
        return rel_attention_reference(q, k, v, emb_rel_k, emb_rel_v, w, key_lens)
    if q.device.type != "cuda":
        raise ValueError(f"rel_attention: unsupported device {q.device}")
    if D not in HEAD_DIMS or not 0 <= w <= MAX_WINDOW:
        raise ValueError(f"rel_attention: need D in {HEAD_DIMS} and w <= {MAX_WINDOW} "
                         f"(D={D}, w={w})")
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape:
            raise ValueError(f"rel_attention: {name} {tuple(x.shape)} != q {tuple(q.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v), ("emb_rel_k", emb_rel_k),
                    ("emb_rel_v", emb_rel_v)):
        if x.dtype != torch.float32 or x.device != q.device:
            raise ValueError(f"rel_attention: {name} must be float32 on {q.device}")
    e_heads = emb_rel_k.shape[0]
    if e_heads not in (1, H) or emb_rel_v.shape[0] != e_heads:
        raise ValueError(f"rel_attention: emb_rel_* need 1 or {H} heads")
    q, k, v = torch.stack((q, k, v))
    ek, ev = emb_rel_k.contiguous(), emb_rel_v.contiguous()
    lens = key_lens.to(device=q.device, dtype=torch.int32).contiguous()
    plan = launch_plan(B * H, T, D, w)
    splits = plan["splits"]
    work = torch.empty(splits * B * H * T * (D + 2 + 2 * w + 1), device=q.device)
    out = torch.empty((B, T, H, D), device=q.device).transpose(1, 2)
    out_strides = (ctypes.c_longlong * 3)(*out.stride()[:3])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib()[1](q.data_ptr(), k.data_ptr(), v.data_ptr(), ek.data_ptr(), ev.data_ptr(),
                    lens.data_ptr(), out.data_ptr(), work.data_ptr(), B, H, T, D, w,
                    e_heads, splits, out_strides, stream)
    build.check(err, "rel_attention")
    LAUNCHES["rel_attention"] += 1
    return out
