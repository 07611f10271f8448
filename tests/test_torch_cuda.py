"""The CUDA kernels against their plain versions on the card, at small
ragged shapes the main path does not reach (batch 2, lengths short of T,
tiles cut by the sequence end). Skips where there is no CUDA device:

    python -m pytest tests/test_torch_cuda.py -m cuda -q      # on the card

Tolerances. K3: 1e-4 relative and absolute, a float32 kernel against its
float32 plain version (TF32 off), so only the summation order differs. K4:
1e-3 relative and 2e-3 absolute, the JAX test's bar for its mel kernel.
K1/K2 compute as the TPU kernel does, with bf16 conv operands and float32
sums, so each is held twice:
- against the plain version with `bf16_operands=True` run in float64 (the
  same bf16 operands, exact sums): rel_l2 <= max(1e-4, 2 x that of the
  same plain version run in float32 by cuDNN), on the output and on its
  update (output - x), which the residual does not dilute. Two float32
  sums of one chain round some bf16 operands apart, and each such flip
  moves the next conv: at k = 11, C = 256 cuDNN's float32 run is itself
  1.7e-4 off the float64 one, so a fixed 1e-4 holds only the small chains;
- against the float32 plain version at the JAX test's bar for the Pallas
  kernel against XLA (tests/unit/test_pallas_resblock.py: atol 2e-2, rtol
  1e-2, corr > 0.9999). Their weights are N(0, 0.01), the decoder's init,
  on which that bar is set."""

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


@pytest.mark.parametrize("B,T", [(1, 16000), (2, 12345), (1, 261120)])
def test_log_mel(dev, B, T):
    audio = 0.3 * torch.randn((B, T), device=dev, generator=_gen(dev, T))
    before = LAUNCHES["log_mel"]
    got = KM.log_mel(audio)
    assert LAUNCHES["log_mel"] == before + 1
    ref = KM.log_mel(audio.cpu()).to(dev)
    torch.testing.assert_close(got, ref, atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("B,H,T,D,w,lens", [
    (1, 2, 200, 96, 10, [200]), (2, 2, 130, 64, 10, [130, 77]), (1, 1, 50, 32, 4, [50]),
    (1, 2, 1000, 96, 10, [1]),
    (1, 2, 1632, 96, 10, [1550]),        # the main path's shape
    (2, 2, 1000, 96, 10, [1000, 677])])  # T cuts a query tile, 677 a key tile; 4 key splits
def test_rel_attention(dev, B, H, T, D, w, lens):
    g = _gen(dev, T)
    q, k, v = (torch.randn((B, H, T, D), device=dev, generator=g) for _ in range(3))
    ek, ev = (0.3 * torch.randn((1, 2 * w + 1, D), device=dev, generator=g) for _ in range(2))
    key_lens = torch.tensor(lens, device=dev, dtype=torch.int32)
    got = KA.rel_attention(q, k, v, ek, ev, w, key_lens)
    ref = KA.rel_attention(*(x.cpu() for x in (q, k, v, ek, ev)), w, key_lens.cpu()).to(dev)
    valid = (torch.arange(T, device=dev)[None, :] < key_lens[:, None])[:, None, :, None]
    torch.testing.assert_close(got * valid, ref * valid, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("channels_first", [False, True])
def test_rel_attention_head_views_match_contiguous(dev, channels_first):
    """Head views of (B, T, H * D) rows, and of a (B, H * D, T) conv output
    seen as (B, T, C) (the TextEncoder's, stride T over D), give what their
    contiguous copies give, bit for bit; the output lies over (B, T, H, D)."""
    B, H, T, D, w = 2, 2, 333, 96, 10
    g = _gen(dev, 7)

    def head_view():
        x = torch.randn((B, H * D, T) if channels_first else (B, T, H * D), device=dev,
                        generator=g)
        return (x.transpose(1, 2) if channels_first else x).reshape(B, T, H, D).transpose(1, 2)

    q, k, v = (head_view() for _ in range(3))
    ek, ev = (0.3 * torch.randn((1, 2 * w + 1, D), device=dev, generator=g) for _ in range(2))
    key_lens = torch.tensor([333, 250], device=dev, dtype=torch.int32)
    got = KA.rel_attention(q, k, v, ek, ev, w, key_lens)
    ref = KA.rel_attention(q.contiguous(), k.contiguous(), v.contiguous(), ek, ev, w, key_lens)
    assert not q.is_contiguous() and got.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(got, ref, atol=0, rtol=0)


def _rel_l2(a, b) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def _f64(a):
    if isinstance(a, tuple):
        return tuple(_f64(t) for t in a)
    return a.double() if isinstance(a, torch.Tensor) else a


def _assert_bf16_kernel(got, plain, x, *args):
    exact = plain(x.double(), *_f64(args), bf16_operands=True)
    emu = plain(x, *args, bf16_operands=True).double()
    xd, g = x.double(), got.double()
    for what, k, e in (("output", _rel_l2(g, exact), _rel_l2(emu, exact)),
                       ("update", _rel_l2(g - xd, exact - xd), _rel_l2(emu - xd, exact - xd))):
        assert k <= max(1e-4, 2 * e), (
            f"{what}: kernel {k:.3g} off the float64 bf16 emulation, cuDNN float32 {e:.3g}")
    ref = plain(x, *args)
    torch.testing.assert_close(got, ref, atol=2e-2, rtol=1e-2)
    corr = float(torch.corrcoef(torch.stack([got.flatten(), ref.flatten()]).double())[0, 1])
    assert corr > 0.9999, f"corr {corr} against the float32 plain version"


def _weights(dev, g, C, K):
    return (0.01 * torch.randn((3, K, C, C), device=dev, generator=g),
            0.1 * torch.randn((3, C), device=dev, generator=g),
            0.01 * torch.randn((3, K, C, C), device=dev, generator=g),
            0.1 * torch.randn((3, C), device=dev, generator=g))


@pytest.mark.parametrize("C", KR.CHANNELS)
@pytest.mark.parametrize("K,T", [(3, 97), (11, 1001), (11, 40)])
def test_resblock_chain(dev, C, K, T):
    g = _gen(dev, C * K)
    x = torch.randn((2, T, C), device=dev, generator=g)
    ws = _weights(dev, g, C, K)
    got = KR.resblock_chain(x, *ws, K, (1, 3, 5))
    _assert_bf16_kernel(got, KR.resblock_chain_reference, x, *ws, K, (1, 3, 5))


@pytest.mark.parametrize("C,T", [(32, 3000), (128, 77)])
def test_resblock_group(dev, C, T):
    g = _gen(dev, C + T)
    x = torch.randn((1, T, C), device=dev, generator=g)
    weights = sum((_weights(dev, g, C, K) for K in (3, 7, 11)), ())
    dil = ((1, 3, 5),) * 3
    got = KR.resblock_group(x, weights, (3, 7, 11), dil)
    _assert_bf16_kernel(got, KR.resblock_group_reference, x, weights, (3, 7, 11), dil)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    with pytest.raises(ValueError):
        KR.resblock_chain(torch.zeros((1, 10, 48), device=dev),
                          *_weights(dev, _gen(dev, 0), 48, 3), 3)
    with pytest.raises(ValueError):
        KM.log_mel(torch.zeros((1, 100), device=dev, dtype=torch.float64))
