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


@pytest.mark.parametrize("nprobe", [1, 4])
def test_ivf_search_and_blend(dev, nprobe):
    """Retrieval on the card (cuBLAS float32 product, torch.topk) against
    the host, Gaussian data where neighbours do not tie: the same ids,
    distances within 1e-4 relative, the same blend."""
    from rvc_tpu_torch.retrieval import build_index, index_blend

    g = torch.Generator().manual_seed(nprobe)
    index = build_index(torch.randn((3000, 768), generator=g).numpy(), nlist=40, device="cpu")
    q = torch.randn((200, 768), generator=g)
    d, i = index.search_device(q.to(dev), 8, nprobe)
    d_ref, i_ref = index.search_device(q, 8, nprobe)
    torch.testing.assert_close(i.cpu(), i_ref, rtol=0, atol=0)
    torch.testing.assert_close(d.cpu(), d_ref, rtol=1e-4, atol=1e-2)
    got = index_blend(q.to(dev), index.tensors(dev)[0][i], d, 0.75)
    ref = index_blend(q, index.tensors("cpu")[0][i_ref], d_ref, 0.75)
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-4, atol=1e-5)


def _tone(seconds: float) -> "np.ndarray":
    import numpy as np

    t = np.arange(int(seconds * 16000)) / 16000
    return (0.4 * np.sin(2 * np.pi * (140 * t + 40 * t * t))).astype(np.float32)


@pytest.mark.parametrize("variant,frames", [("tiny", 400), ("full", 24)])
def test_crepe_frames_match_the_host(dev, variant, frames):
    """CREPE's network (cuDNN convs, float32, TF32 off) against the host, on
    normalized frames: the JAX test's bar for CREPE against torchcrepe."""
    from rvc_tpu_torch.models.crepe import CREPE, frame_audio

    crepe = CREPE(variant, device=dev)
    x = frame_audio(torch.from_numpy(_tone(frames / 100))[None])[0][:frames]
    with torch.inference_mode():
        got = crepe.model(x.to(dev)).cpu()
        ref = crepe.model.cpu()(x)
    torch.testing.assert_close(got, ref, rtol=2e-3, atol=2e-4)


def test_fcpe_full_width_matches_the_host(dev):
    """FCPE 12 x 512 on a 2 s clip's log-mel, card against host. The clip
    carries broadband noise, so no mel band holds only the two FFTs'
    float32 round-off."""
    from rvc_tpu_torch.models.fcpe import FCPE

    fcpe = FCPE(device=dev)
    noise = 0.05 * torch.randn(32000, generator=torch.Generator().manual_seed(0))
    audio = (torch.from_numpy(_tone(2.0)) + noise)[None]
    with torch.inference_mode():
        mel = fcpe.mel(audio)
        torch.testing.assert_close(fcpe.mel(audio.to(dev)).cpu(), mel, rtol=1e-4, atol=1e-4)
        got = fcpe.model(mel.to(dev)).cpu()
        ref = fcpe.model.cpu()(mel)
    torch.testing.assert_close(got, ref, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("method", ["crepe-tiny", "fcpe", "rmvpe", "hybrid[rmvpe+pm]"])
def test_extractor_keeps_its_models_on_the_card(dev, method):
    import numpy as np

    from rvc_tpu_torch.pitch import PitchExtractor

    ext = PitchExtractor(method, device="cuda")
    for sub in ext._sub or [ext]:
        if sub._model is not None:
            assert next(sub._model.model.parameters()).is_cuda
    f0 = ext.extract(_tone(1.0))
    assert isinstance(f0, np.ndarray) and f0.dtype == np.float32 and f0.shape[0] in (100, 101)


def test_staged_rmvpe_launches_k4_once(dev):
    """proposed_pitch takes RMVPE down the staged path: one log-mel launch
    for the one chunk, K1-K3 as on every path; crepe-tiny launches no K4."""
    from rvc_tpu_torch.api import RVC
    from rvc_tpu_torch.configs import get_config
    from rvc_tpu_torch.ops.kernels import reset_launches

    rvc = RVC(config=get_config(32000, model_n_layers=1), device="cuda")
    for kw, mels in ((dict(proposed_pitch=True), 1), (dict(f0_method="crepe-tiny"), 0)):
        reset_launches()
        out = rvc.infer(_tone(1.0), **kw)
        torch.cuda.synchronize()
        assert out.shape == (32000,) and LAUNCHES["log_mel"] == mels, (kw, dict(LAUNCHES))
        assert min(LAUNCHES["rel_attention"], LAUNCHES["resblock_group"],
                   LAUNCHES["resblock_chain"]) > 0


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    with pytest.raises(ValueError):
        KR.resblock_chain(torch.zeros((1, 10, 48), device=dev),
                          *_weights(dev, _gen(dev, 0), 48, 3), 3)
    with pytest.raises(ValueError):
        KM.log_mel(torch.zeros((1, 100), device=dev, dtype=torch.float64))
