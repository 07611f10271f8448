"""K3: fused windowed rel-pos attention (wrapper of `csrc/rel_attention.cu`).

Replaces `rvc_tpu/ops/pallas/attention.py : fused_rel_attention`; the
TextEncoder's attention calls it. For a CPU tensor it runs the plain
version, `rel_attention_reference` (`ops.attention.relative_attention_xla`
with the key-mask outer product); for a CUDA tensor it launches the kernel
or raises. As on the TPU, query rows at or past a sequence's length
differ between the two on purpose (the plain version softmaxes a fully
masked row to uniform, the kernel attends over the valid keys): both are
garbage rows that every caller multiplies away.
"""

from __future__ import annotations

import ctypes

import torch

from rvc_tpu_torch.ops.attention import relative_attention_xla
from rvc_tpu_torch.ops.commons import sequence_mask
from rvc_tpu_torch.ops.kernels import LAUNCHES, build, recorded


def _lib():
    fn = build.load("rel_attention").rvc_rel_attention
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
    if D > 128 or 2 * w + 1 > 32:
        raise ValueError(f"rel_attention: need D <= 128 and 2w+1 <= 32 (D={D}, w={w})")
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape:
            raise ValueError(f"rel_attention: {name} {tuple(x.shape)} != q {tuple(q.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v), ("emb_rel_k", emb_rel_k),
                    ("emb_rel_v", emb_rel_v)):
        if x.dtype != torch.float32 or x.device != q.device:
            raise ValueError(f"rel_attention: {name} must be float32 on {q.device}")
    qs = (q * (1.0 / D ** 0.5)).contiguous()
    band = (qs @ emb_rel_k.transpose(-1, -2)).contiguous()      # (B, H, T, 2w+1)
    k, v = k.contiguous(), v.contiguous()
    lens = key_lens.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(qs)
    bw = torch.empty_like(band)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib()(qs.data_ptr(), k.data_ptr(), v.data_ptr(), band.data_ptr(),
                 lens.data_ptr(), out.data_ptr(), bw.data_ptr(), B, H, T, D, w,
                 stream)
    build.check(err, "rel_attention")
    LAUNCHES["rel_attention"] += 1
    return out + bw @ emb_rel_v
