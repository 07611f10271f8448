"""K1/K2 plain versions against the reference's XLA chains (float32) and
the TPU kernels in interpret mode (bf16 taps)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_tpu.ops.pallas import resblock as R
from rvc_tpu_torch.ops.kernels import LAUNCHES
from rvc_tpu_torch.ops.kernels.resblock import resblock_chain, resblock_group

DIL = (1, 3, 5)


def _weights(rng, C, K, S=3):
    """w (S, K, C, C) ~ N(0, 0.01) as the decoder's init, biases ~ U(+-0.1)."""
    return (
        (0.01 * rng.standard_normal((S, K, C, C))).astype(np.float32),
        rng.uniform(-0.1, 0.1, (S, C)).astype(np.float32),
        (0.01 * rng.standard_normal((S, K, C, C))).astype(np.float32),
        rng.uniform(-0.1, 0.1, (S, C)).astype(np.float32),
    )


def _x(rng, T, C):
    return rng.standard_normal((1, T, C)).astype(np.float32)


@pytest.mark.parametrize("K,C,T", [(3, 32, 300), (7, 256, 257), (11, 32, 700),
                                   (11, 256, 131)])
def test_chain_matches_reference_xla(K, C, T):
    """float32 convs on both sides: atol 1e-5."""
    rng = np.random.default_rng(K * C + T)
    x, ws = _x(rng, T, C), _weights(rng, C, K)
    ref = np.asarray(R._xla_resblock(jnp.asarray(x), *map(jnp.asarray, ws),
                                     kernel_size=K, dilations=DIL, slope=0.1))
    before = LAUNCHES["resblock_chain"]
    got = resblock_chain(torch.from_numpy(x), *map(torch.from_numpy, ws), K, DIL).numpy()
    assert LAUNCHES["resblock_chain"] == before
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("C,T", [(32, 450), (256, 130)])
def test_group_matches_reference_xla(C, T):
    rng = np.random.default_rng(C + T)
    x = _x(rng, T, C)
    weights = sum((_weights(rng, C, K) for K in (3, 7, 11)), ())
    ref = np.asarray(R._xla_resblock_group(
        jnp.asarray(x), tuple(map(jnp.asarray, weights)), kernel_sizes=(3, 7, 11),
        dilations=(DIL,) * 3, slope=0.1))
    got = resblock_group(torch.from_numpy(x), tuple(map(torch.from_numpy, weights)),
                         (3, 7, 11), (DIL,) * 3).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def _close_to_bf16_kernel(got, ref):
    """The TPU kernels feed bf16 taps to the MXU: the JAX test's own bar
    (tests/unit/test_pallas_resblock.py: atol 2e-2, corr > 0.9999)."""
    np.testing.assert_allclose(got, ref, atol=2e-2, rtol=1e-2)
    assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > 0.9999


@pytest.mark.parametrize("K,C,T", [(11, 32, 700), (3, 256, 200)])
def test_chain_matches_pallas_interpret(K, C, T):
    rng = np.random.default_rng(7 + K)
    x, ws = _x(rng, T, C), _weights(rng, C, K)
    ref = np.asarray(R.fused_resblock(jnp.asarray(x), *map(jnp.asarray, ws), K, DIL,
                                      interpret=True))
    got = resblock_chain(torch.from_numpy(x), *map(torch.from_numpy, ws), K, DIL).numpy()
    _close_to_bf16_kernel(got, ref)


def test_group_matches_pallas_interpret():
    rng = np.random.default_rng(11)
    C, T = 32, 450
    x = _x(rng, T, C)
    weights = sum((_weights(rng, C, K) for K in (3, 7, 11)), ())
    ref = np.asarray(R.fused_resblock_group(
        jnp.asarray(x), tuple(map(jnp.asarray, weights)), (3, 7, 11), (DIL,) * 3,
        interpret=True))
    got = resblock_group(torch.from_numpy(x), tuple(map(torch.from_numpy, weights)),
                         (3, 7, 11), (DIL,) * 3).numpy()
    _close_to_bf16_kernel(got, ref)
