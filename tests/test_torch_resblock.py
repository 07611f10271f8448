"""K1/K2 plain versions against the reference's XLA chains (float32) and
the TPU kernels in interpret mode (bf16 taps); the bf16 emulation
(`bf16_operands=True`, the CUDA kernel's arithmetic) against the TPU
kernels; the kernel's weight layout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_tpu.ops.pallas import resblock as R
from rvc_tpu_torch.ops.kernels import LAUNCHES
from rvc_tpu_torch.ops.kernels.resblock import (kernel_weights, resblock_chain,
                                                resblock_chain_reference, resblock_group,
                                                resblock_group_reference)

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


@pytest.mark.parametrize("K,C,T", [(11, 32, 700), (3, 256, 200), (7, 64, 500), ("group", 32, 450)])
def test_bf16_emulation_matches_pallas_interpret(K, C, T):
    """Both sides round the conv operands to bf16 and sum in float32, so
    only the order of the sums differs: rel_l2 <= 1e-4 and atol 1e-3."""
    rng = np.random.default_rng(23 + C + T)
    x = _x(rng, T, C)
    if K == "group":
        weights = sum((_weights(rng, C, k) for k in (3, 7, 11)), ())
        ref = np.asarray(R.fused_resblock_group(
            jnp.asarray(x), tuple(map(jnp.asarray, weights)), (3, 7, 11), (DIL,) * 3,
            interpret=True))
        got = resblock_group_reference(torch.from_numpy(x),
                                       tuple(map(torch.from_numpy, weights)),
                                       (3, 7, 11), (DIL,) * 3, bf16_operands=True).numpy()
    else:
        ws = _weights(rng, C, K)
        ref = np.asarray(R.fused_resblock(jnp.asarray(x), *map(jnp.asarray, ws), K, DIL,
                                          interpret=True))
        got = resblock_chain_reference(torch.from_numpy(x), *map(torch.from_numpy, ws), K,
                                       DIL, bf16_operands=True).numpy()
    rel_l2 = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel_l2 <= 1e-4, rel_l2
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)


def test_kernel_weights_are_bf16_taps_out_major():
    """(S, K, Cin, Cout) float32 -> (S, Cout, K, Cin) bf16: reading it back
    in the reference's layout gives bf16(w)."""
    w = torch.from_numpy(np.random.default_rng(5).standard_normal((3, 7, 32, 64))
                         .astype(np.float32))
    kw = kernel_weights(w)
    assert kw.dtype == torch.bfloat16 and kw.is_contiguous()
    assert kw.shape == (3, 64, 7, 32)
    assert torch.equal(kw.permute(0, 2, 3, 1), w.to(torch.bfloat16))
