"""K3's plain version against the reference's rel-pos attention and the
TPU kernel in interpret mode, with ragged lengths."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_tpu.ops.attention import relative_attention_xla as jax_rel_attention
from rvc_tpu.ops.pallas.attention import fused_rel_attention
from rvc_tpu_torch.ops.attention import relative_attention_xla
from rvc_tpu_torch.ops.kernels import LAUNCHES
from rvc_tpu_torch.ops.kernels.attention import rel_attention


def _case(seed, B, H, T, D, w, lens):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, T, D)).astype(np.float32) for _ in range(3))
    ek, ev = (0.3 * rng.standard_normal((1, 2 * w + 1, D)).astype(np.float32)
              for _ in range(2))
    key_mask = (np.arange(T)[None, :] < np.asarray(lens)[:, None]).astype(np.float32)
    return q, k, v, ek, ev, key_mask


CASES = [
    (1, 2, 200, 96, 10, [200]),       # enc_p shape class
    (1, 2, 384, 96, 10, [300]),       # masked tail
    (2, 2, 130, 64, 10, [130, 77]),   # per-row lengths
    (1, 1, 50, 32, 4, [50]),          # T < 2w + 1 blocks, small window
]


@pytest.mark.parametrize("B,H,T,D,w,lens", CASES)
def test_plain_matches_reference_xla(B, H, T, D, w, lens):
    """Same skew formulation, float32 on both sides: rtol 2e-4, atol 2e-5."""
    q, k, v, ek, ev, km = _case(0, B, H, T, D, w, lens)
    am = km[:, None, None, :] * km[:, None, :, None]
    ref = np.asarray(jax_rel_attention(*map(jnp.asarray, (q, k, v, ek, ev)), w,
                                       jnp.asarray(am)))
    got = relative_attention_xla(*map(torch.from_numpy, (q, k, v, ek, ev)), w,
                                 torch.from_numpy(am)).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("B,H,T,D,w,lens", CASES)
def test_wrapper_matches_pallas_interpret_on_valid_rows(B, H, T, D, w, lens):
    """The wrapper on a CPU tensor (plain version) against the TPU kernel
    in interpret mode; rows past the length differ by design."""
    q, k, v, ek, ev, km = _case(1, B, H, T, D, w, lens)
    ref = np.asarray(fused_rel_attention(*map(jnp.asarray, (q, k, v, ek, ev)), w,
                                         jnp.asarray(lens, jnp.int32), interpret=True))
    before = LAUNCHES["rel_attention"]
    got = rel_attention(*map(torch.from_numpy, (q, k, v, ek, ev)), w,
                        torch.tensor(lens, dtype=torch.int32)).numpy()
    assert LAUNCHES["rel_attention"] == before
    m = km[:, None, :, None]
    np.testing.assert_allclose(got * m, ref * m, rtol=2e-4, atol=2e-5)


BQ, BK = 64, 32   # csrc/rel_attention.cu: query rows a block, keys a tile


def _emulate_kernel(q, k, v, ek, ev, w, lens, splits):
    """The CUDA kernel's algorithm in plain torch float32: per 64-row query
    tile, key splits of whole 32-key tiles, each an online softmax with the
    band bias added in the tiles that cross the diagonal and the band's final
    logits kept; then the log-sum-exp merge of the splits, the band weights
    exp(logit - m) / l and their rel-v term."""
    B, H, T, D = q.shape
    NW = 2 * w + 1
    qs = q / D ** 0.5
    out = torch.zeros_like(q)
    for b in range(B):
        L = int(lens[b])
        n_kt = -(-(min(L, T) if L >= 1 else T) // BK)
        per = -(-n_kt // splits)
        for h in range(H):
            e_k, e_v = ek[0 if ek.shape[0] == 1 else h], ev[0 if ev.shape[0] == 1 else h]
            for q0 in range(0, T, BQ):
                rows = torch.arange(q0, min(q0 + BQ, T))
                Q = qs[b, h, rows]
                band = Q @ e_k.T
                parts = []
                for s in range(splits):
                    kt0 = min(s * per, n_kt)
                    kt1 = min(kt0 + per, n_kt)
                    m = torch.full((len(rows),), -torch.inf)
                    l = torch.zeros(len(rows))
                    O = torch.zeros(len(rows), D)
                    bl = torch.full((len(rows), NW), -torch.inf)
                    for kt in range(kt0, kt1):
                        keys = torch.arange(kt * BK, (kt + 1) * BK)
                        kv = keys.clamp(max=T - 1)
                        x = Q @ k[b, h, kv].T
                        rel = keys[None, :] - rows[:, None] + w
                        inb = (rel >= 0) & (rel < NW)
                        x = x + torch.where(inb, band.gather(1, rel.clamp(0, NW - 1)), 0.0)
                        x = torch.where(keys >= L, -1e4, x)
                        x = torch.where(keys >= T, -torch.inf, x)
                        r_idx = torch.arange(len(rows))[:, None].expand_as(rel)
                        bl[r_idx[inb], rel[inb]] = x[inb]
                        m_new = torch.maximum(m, x.max(1).values)
                        alpha = torch.exp(m - m_new)
                        p = torch.exp(x - m_new[:, None])
                        l = l * alpha + p.sum(1)
                        O = O * alpha[:, None] + p @ v[b, h, kv]
                        m = m_new
                    parts.append((m, l, O, bl))
                ms, ls, Os, bls = (torch.stack(t) for t in zip(*parts))
                M = ms.max(0).values
                wts = torch.where(ls > 0, torch.exp(ms - M), 0.0)
                Lt = (ls * wts).sum(0)
                bw = torch.exp(bls.max(0).values - M[:, None]) / Lt[:, None]
                out[b, h, rows] = (wts[:, :, None] * Os).sum(0) / Lt[:, None] + bw @ e_v
    return out


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("B,H,T,D,w,lens", CASES)
def test_kernel_algorithm_matches_pallas_interpret_on_valid_rows(B, H, T, D, w, lens, splits):
    """The CUDA kernel's tiling, key splits and merge, emulated in torch,
    against the TPU kernel in interpret mode on valid rows, at this file's
    float32 bar (rtol 2e-4, atol 2e-5)."""
    q, k, v, ek, ev, km = _case(2, B, H, T, D, w, lens)
    ref = np.asarray(fused_rel_attention(*map(jnp.asarray, (q, k, v, ek, ev)), w,
                                         jnp.asarray(lens, jnp.int32), interpret=True))
    got = _emulate_kernel(*map(torch.from_numpy, (q, k, v, ek, ev)), w, lens, splits).numpy()
    m = km[:, None, :, None]
    np.testing.assert_allclose(got * m, ref * m, rtol=2e-4, atol=2e-5)
