"""The CUDA kernels against their plain versions on the card, at small
ragged shapes the main path does not reach (batch 2, lengths short of T,
tiles cut by the sequence end). Skips where there is no CUDA device:

    python -m pytest tests/test_torch_cuda.py -m cuda -q      # on the card

Tolerances: float32 kernels against float32 plain versions (TF32 off), so
only the summation order differs. K3: 1e-4 relative and absolute. K1/K2
sum up to C*K = 2,816 products per conv, six convs deep, so their rounding
grows with the output: each is held against a float64 run of the plain
version, and its largest error there may be at most 4x the float32 plain
version's own. K4: 1e-3 relative and 2e-3 absolute, the JAX test's bar for
its mel kernel."""

import pytest
import torch

from rvc_tpu_torch.ops.kernels import LAUNCHES
from rvc_tpu_torch.ops.kernels import attention as KA
from rvc_tpu_torch.ops.kernels import melspec as KM
from rvc_tpu_torch.ops.kernels import resblock as KR
from rvc_tpu_torch.utils.device import use_fp32_numerics

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    use_fp32_numerics()
    return torch.device("cuda")


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


@pytest.mark.parametrize("B,T", [(1, 16000), (2, 12345)])
def test_log_mel(dev, B, T):
    audio = 0.3 * torch.randn((B, T), device=dev, generator=_gen(dev, T))
    before = LAUNCHES["log_mel"]
    got = KM.log_mel(audio)
    assert LAUNCHES["log_mel"] == before + 1
    ref = KM.log_mel(audio.cpu()).to(dev)
    torch.testing.assert_close(got, ref, atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("B,H,T,D,w,lens", [
    (1, 2, 200, 96, 10, [200]), (2, 2, 130, 64, 10, [130, 77]), (1, 1, 50, 32, 4, [50]),
    (1, 2, 1000, 96, 10, [1])])
def test_rel_attention(dev, B, H, T, D, w, lens):
    g = _gen(dev, T)
    q, k, v = (torch.randn((B, H, T, D), device=dev, generator=g) for _ in range(3))
    ek, ev = (0.3 * torch.randn((1, 2 * w + 1, D), device=dev, generator=g) for _ in range(2))
    key_lens = torch.tensor(lens, device=dev, dtype=torch.int32)
    got = KA.rel_attention(q, k, v, ek, ev, w, key_lens)
    ref = KA.rel_attention(*(x.cpu() for x in (q, k, v, ek, ev)), w, key_lens.cpu()).to(dev)
    valid = (torch.arange(T, device=dev)[None, :] < key_lens[:, None])[:, None, :, None]
    torch.testing.assert_close(got * valid, ref * valid, atol=1e-4, rtol=1e-4)


def _f64(a):
    if isinstance(a, tuple):
        return tuple(_f64(t) for t in a)
    return a.double() if isinstance(a, torch.Tensor) else a


def _assert_conv_close(got, plain, *args):
    ref = plain(*args)
    exact = plain(*(_f64(a) for a in args))
    kernel_err = float((got.double() - exact).abs().max())
    plain_err = float((ref.double() - exact).abs().max())
    assert kernel_err <= 4 * plain_err + 1e-7, (
        f"kernel {kernel_err:.3g} off float64, plain float32 {plain_err:.3g}, "
        f"max|ref| {float(exact.abs().max()):.4g}")


def _weights(dev, g, C, K):
    return (0.05 * torch.randn((3, K, C, C), device=dev, generator=g),
            0.1 * torch.randn((3, C), device=dev, generator=g),
            0.05 * torch.randn((3, K, C, C), device=dev, generator=g),
            0.1 * torch.randn((3, C), device=dev, generator=g))


@pytest.mark.parametrize("C", KR.CHANNELS)
@pytest.mark.parametrize("K,T", [(3, 97), (11, 1001)])
def test_resblock_chain(dev, C, K, T):
    g = _gen(dev, C * K)
    x = torch.randn((2, T, C), device=dev, generator=g)
    ws = _weights(dev, g, C, K)
    got = KR.resblock_chain(x, *ws, K, (1, 3, 5))
    _assert_conv_close(got, KR.resblock_chain_reference, x, *ws, K, (1, 3, 5))


@pytest.mark.parametrize("C,T", [(32, 3000), (128, 77)])
def test_resblock_group(dev, C, T):
    g = _gen(dev, C + T)
    x = torch.randn((1, T, C), device=dev, generator=g)
    weights = sum((_weights(dev, g, C, K) for K in (3, 7, 11)), ())
    dil = ((1, 3, 5),) * 3
    got = KR.resblock_group(x, weights, (3, 7, 11), dil)
    _assert_conv_close(got, KR.resblock_group_reference, x, weights, (3, 7, 11), dil)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    with pytest.raises(ValueError):
        KR.resblock_chain(torch.zeros((1, 10, 48), device=dev),
                          *_weights(dev, _gen(dev, 0), 48, 3), 3)
    with pytest.raises(ValueError):
        KM.log_mel(torch.zeros((1, 100), device=dev, dtype=torch.float64))
