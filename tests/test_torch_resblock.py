"""K1/K2 plain versions against the reference's XLA chains (float32) and
the TPU kernels in interpret mode (bf16 taps); the bf16 emulation
(`bf16_operands=True`, the CUDA kernel's arithmetic) against the TPU
kernels; the kernel's weight layouts and their cache; the launch plan and
its tiled emulation (`resblock_group_tiled_reference`) against the
untiled plain version and the TPU kernels; K1's packed-lane entry against
the TPU kernel's, with its gradient."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_tpu.ops.pallas import resblock as R
from rvc_tpu_torch.ops.kernels import LAUNCHES, KernelFunction
from rvc_tpu_torch.models.layers import ResBlock
from rvc_tpu_torch.ops.kernels import resblock as KR
from rvc_tpu_torch.ops.kernels.resblock import (kernel_weights,
                                                resblock_chain, resblock_chain_reference,
                                                resblock_group, resblock_group_packed,
                                                resblock_group_packed_reference,
                                                resblock_group_reference,
                                                resblock_group_tiled_reference)

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


def _packed(x, rows, P):
    """(1, T, C) numpy -> the packed (1, rows, P * C), zeros past T."""
    _, T, C = x.shape
    return np.pad(x, ((0, 0), (0, rows * P - T), (0, 0))).reshape(1, rows, P * C)


@pytest.mark.parametrize("C,T", [(32, 48), (64, 50), (32, 50), (64, 51)])
def test_group_packed_matches_pallas_interpret(C, T):
    """The packed entry at the decoder's C = 32 / 64 layouts, the first T
    steps against the TPU kernel in interpret mode at K1's bar. The JAX
    packed entry takes R * P = T only (its assert); where T is not a
    multiple of P the JAX side is K1's unpacked entry on the T steps, whose
    kernel packs x the same way and masks the steps past T alike."""
    rng = np.random.default_rng(31 + C + T)
    P = 128 // C
    rows = -(-T // P)
    x = _x(rng, T, C)
    weights = sum((_weights(rng, C, K) for K in (3, 7, 11)), ())
    jw = tuple(map(jnp.asarray, weights))
    if rows * P == T:
        ref = np.asarray(R.resblock_group_packed(jnp.asarray(_packed(x, rows, P)), jw,
                                                 (3, 7, 11), (DIL,) * 3, C, T))
        ref = ref.reshape(1, T, C)
    else:
        ref = np.asarray(R.fused_resblock_group(jnp.asarray(x), jw, (3, 7, 11), (DIL,) * 3,
                                                interpret=True))
    before = LAUNCHES["resblock_group_packed"]
    got = resblock_group_packed(torch.from_numpy(_packed(x, rows, P)),
                                tuple(map(torch.from_numpy, weights)), (3, 7, 11), (DIL,) * 3,
                                C, T).numpy()
    assert LAUNCHES["resblock_group_packed"] == before
    assert got.shape == (1, rows, 128)
    got = got.reshape(1, rows * P, C)
    assert not got[:, T:].any()
    _close_to_bf16_kernel(got[:, :T], ref)


def test_group_packed_gradient_matches_autograd():
    """The packed stage's backward under `KernelFunction` (unfold, the plain
    stage's vjp, refold) against autograd through the plain stage on the unfolded
    steps: every gradient within 1e-5 (rel_l2); the steps past T get
    none."""
    rng = np.random.default_rng(41)
    C, T, P = 32, 50, 4
    rows = -(-T // P)
    x = torch.from_numpy(_packed(_x(rng, T, C), rows, P)).requires_grad_()
    weights = tuple(torch.from_numpy(w).requires_grad_()
                    for w in sum((_weights(rng, C, K) for K in (3, 7, 11)), ()))
    g = torch.from_numpy(rng.standard_normal((1, rows, P * C)).astype(np.float32))
    plain = lambda x, *w: resblock_group_packed_reference(x, w, (3, 7, 11), (DIL,) * 3, C, T)
    out = KernelFunction.apply(plain, plain, x, *weights)
    got = torch.autograd.grad(out, (x, *weights), g)
    xu = x.detach().reshape(1, rows * P, C)[:, :T].clone().requires_grad_()
    ref_out = resblock_group_reference(xu, weights, (3, 7, 11), (DIL,) * 3)
    ref = torch.autograd.grad(ref_out, (xu, *weights), g.reshape(1, rows * P, C)[:, :T])
    gx = got[0].reshape(1, rows * P, C)
    assert not gx[:, T:].any()
    for a, b in zip((gx[:, :T], *got[1:]), ref):
        assert float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)) < 1e-5


@pytest.mark.parametrize("shape,channels,t_valid", [
    ((1, 12, 128), 48, 40), ((1, 12, 64), 32, 48), ((1, 12, 128), 32, 49)])
def test_group_packed_refuses_a_bad_layout(shape, channels, t_valid):
    """C outside (128, 64, 32), rows narrower than P * C, or more valid
    steps than R * P hold: ValueError."""
    x = torch.zeros(shape)
    weights = tuple(torch.zeros(3, k, 32, 32) if j % 2 == 0 else torch.zeros(3, 32)
                    for k in (3, 7, 11) for j in range(4))
    with pytest.raises(ValueError):
        resblock_group_packed(x, weights, (3, 7, 11), (DIL,) * 3, channels, t_valid)


# --- the launch plan, its tiled emulation, the weight cache -----------------
# The 48 kHz model's decoder: K2 on its C = 256 stage, K1 on 128, 64, 32; T
# of the main path's 13.5 s clip, the realtime block and a training segment.
STAGE_T = {"main": (19584, 195840, 391680, 783360), "realtime": (2280, 22800, 45600, 91200),
           "train": (432, 4320, 8640, 17280)}
KS = (3, 7, 11)


@pytest.mark.parametrize("path", sorted(STAGE_T))
@pytest.mark.parametrize("stage", range(4))
def test_launch_plan_fits(path, stage):
    """Every plan fits the H100's 232,448 shared bytes a block with a halo no
    smaller than its receptive field; K1 at C = 32, 64, 128 is one launch
    a call, K2 at C = 256 one launch per dilation step (3 a chain)."""
    C, T = (256, 128, 64, 32)[stage], STAGE_T[path][stage]
    plans = ([KR.launch_plan(C, T, (k,), (DIL,)) for k in KS] if C == 256
             else [KR.launch_plan(C, T, KS, (DIL,) * 3)])
    for plan in plans:
        assert plan["smem_bytes"] <= 232448 and plan["stages"] >= 2, plan
        assert plan["blocks"] >= 1 and plan["tile"] >= 64
    if C == 256:
        for k, plan in zip(KS, plans):
            assert plan["mode"] == "step" and plan["launches"] == 3
            assert plan["tiles"] == [128 - (k - 1)]
            assert plan["halo"] >= (k - 1) // 2 * 6
    else:
        plan, = plans
        assert plan["mode"] == "one_pass" and plan["launches"] == 1
        assert plan["halo"] >= max(KR.chain_halo(k, DIL) for k in KS) == 60
        assert plan["tile"] == {32: 512, 64: 256, 128: 128}[C]
        assert plan["window"] == plan["tile"] + 2 * plan["halo"]


def test_launch_plan_refuses_what_it_cannot_tile():
    """C outside the four, an even kernel, a window (one-pass) or a step
    plane (C = 256) larger than a block's shared memory: ValueError; a
    larger halo at C = 32 still fits, on a smaller tile."""
    with pytest.raises(ValueError):
        KR.launch_plan(48, 100, KS, (DIL,) * 3)
    with pytest.raises(ValueError):
        KR.launch_plan(32, 100, (4,), (DIL,))
    with pytest.raises(ValueError):
        KR.launch_plan(128, 100, (11,), ((1, 3, 60),))
    with pytest.raises(ValueError):
        KR.launch_plan(256, 100, (11,), ((1, 3, 40),))
    plan = KR.launch_plan(32, 100, (11,), ((1, 3, 40),))
    assert plan["mode"] == "one_pass" and plan["halo"] == 235 and 64 <= plan["tile"] < 512


def _stage(rng, C, B, T):
    x = torch.from_numpy(rng.standard_normal((B, T, C)).astype(np.float32))
    weights = tuple(map(torch.from_numpy, sum((_weights(rng, C, K) for K in KS), ())))
    return x, weights


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


# (C, B, T): below one tile, not a multiple of the tile, below the halo, B = 2
TILED = [(32, 1, 300), (32, 2, 1100), (32, 1, 50), (64, 2, 200), (64, 1, 600), (64, 2, 59),
         (128, 1, 100), (128, 2, 333), (128, 1, 61), (256, 2, 100), (256, 1, 300), (256, 1, 7)]


@pytest.mark.parametrize("C,B,T", TILED)
def test_tiled_reference_matches_untiled(C, B, T):
    """The plan's tiles, halo and boundary zeroing reproduce the untiled plain
    stage in float32 (rel_l2 <= 1e-6)."""
    rng = np.random.default_rng(C * 7 + B + T)
    x, weights = _stage(rng, C, B, T)
    ref = resblock_group_reference(x, weights, KS, (DIL,) * 3)
    got = resblock_group_tiled_reference(x, weights, KS, (DIL,) * 3)
    assert got.shape == ref.shape
    assert _rel_l2(got, ref) <= 1e-6


@pytest.mark.parametrize("C,B,T", [(32, 2, 600), (64, 1, 59), (128, 1, 300), (256, 2, 130)])
def test_tiled_reference_matches_pallas_interpret(C, B, T):
    """The tiled bf16 emulation against the TPU kernels in interpret mode
    (`fused_resblock_group`; at C = 256 `fused_resblock` per chain, as the
    decoder runs K2 there): rel_l2 <= 1e-4, the bf16 emulation's bar."""
    rng = np.random.default_rng(3 * C + B + T)
    x, weights = _stage(rng, C, B, T)
    jw = tuple(jnp.asarray(w.numpy()) for w in weights)
    if C == 256:
        ref = sum(np.asarray(R.fused_resblock(jnp.asarray(x.numpy()), *jw[4 * i: 4 * i + 4], k,
                                              DIL, interpret=True)) for i, k in enumerate(KS)) / 3
    else:
        ref = np.asarray(R.fused_resblock_group(jnp.asarray(x.numpy()), jw, KS, (DIL,) * 3,
                                                interpret=True))
    got = resblock_group_tiled_reference(x, weights, KS, (DIL,) * 3, bf16_operands=True)
    assert _rel_l2(got.numpy(), ref) <= 1e-4


def test_tma_weights_are_swizzled_bf16_chunks():
    """(S, K, Cin, Cout) -> (S, ceil(K Cin / 64), Cout, 64) bf16: undoing the
    128-byte swizzle (unit u of row r at u ^ (r % 8)) and the zero padding
    gives `kernel_weights`."""
    w = torch.from_numpy(np.random.default_rng(6).standard_normal((3, 7, 32, 64))
                         .astype(np.float32))
    tw = KR.tma_weights(w)
    assert tw.dtype == torch.bfloat16 and tw.shape == (3, 4, 64, 64) and tw.is_contiguous()
    units = tw.reshape(3, 4, 64, 8, 8)
    src = torch.arange(8)[None, :] ^ (torch.arange(64)[:, None] % 8)
    plain = torch.gather(units, 3, src[None, None, :, :, None].expand(3, 4, 64, 8, 8))
    plain = plain.reshape(3, 4, 64, 64).permute(0, 2, 1, 3).reshape(3, 64, 256)
    assert not plain[:, :, 224:].any()
    assert torch.equal(plain[:, :, :224].reshape(3, 64, 7, 32), kernel_weights(w))


@pytest.mark.parametrize("layout", ["kernel_weights", "tma_weights"])
def test_weight_cache_follows_versions(layout):
    """`cached` returns the same tensor until an in-place update bumps the
    source's `_version`, then the new values' layout; a freed source drops
    its entry; inference tensors are never kept."""
    make = getattr(KR, layout)
    w = torch.from_numpy(np.random.default_rng(8).standard_normal((3, 3, 32, 32))
                         .astype(np.float32))
    first = KR.cached(layout, (w,), lambda: make(w))
    assert KR.cached(layout, (w,), lambda: make(w)) is first
    with torch.no_grad():
        w.mul_(2.0)
    again = KR.cached(layout, (w,), lambda: make(w))
    assert again is not first and torch.equal(again, make(w))
    assert not torch.equal(again, first)
    assert KR.cached(layout, (w,), lambda: make(w)) is again
    key = (layout, id(w))
    assert key in KR._CACHE
    del w
    assert key not in KR._CACHE
    with torch.inference_mode():
        v = torch.ones(3, 3, 32, 32)
        assert KR.cached(layout, (v,), lambda: make(v)) is not KR.cached(
            layout, (v,), lambda: make(v))


def test_stacked_weights_kept_per_parameter_version():
    """Under no-grad `ResBlock.stacked_weights` returns the same tensors until
    a parameter changes in place; with autograd on, fresh ones that carry
    the graph; `drop_cache` forgets them and their conversions."""
    block = ResBlock(32, 3, DIL)
    with torch.no_grad():
        a = block.stacked_weights()
        assert block.stacked_weights() is a
        KR.stage_buffers(a)
        assert any(id(a[0]) in k for k in KR._CACHE)
        block.convs2[1].weight.add_(1.0)
        b = block.stacked_weights()
        assert b is not a and torch.equal(b[2][1], block.convs2[1].weight.permute(2, 1, 0))
    grad = block.stacked_weights()
    assert grad is not b and grad[0].requires_grad
    with torch.no_grad():
        c = block.stacked_weights()
        KR.stage_buffers(c)
        block.drop_cache()
        assert not any(id(c[0]) in k for k in KR._CACHE)
        assert block.stacked_weights() is not c
