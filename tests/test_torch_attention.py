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
