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


@pytest.mark.parametrize("vocoder", ["MRF HiFi-GAN", "RefineGAN"])
def test_vocoder_matches_the_host(dev, vocoder):
    """The MRF HiFi-GAN and RefineGAN decoders at full 48 kHz width (plain
    cuDNN convs, float32, TF32 off) on 60 frames, card against host, noise
    off: waveform corr > 0.9999."""
    from rvc_tpu_torch.configs import get_config
    from rvc_tpu_torch.models.synthesizer import build_synthesizer

    torch.manual_seed(0)
    dec = build_synthesizer(get_config(48000, model_vocoder=vocoder)).dec.eval()
    g = torch.Generator().manual_seed(1)
    z = torch.randn((1, 60, 192), generator=g)
    spk = torch.randn((1, 1, 256), generator=g)
    f0 = 140.0 + 40.0 * torch.sin(torch.arange(60.0) / 6.0)[None]
    f0[:, 20:26] = 0.0
    with torch.inference_mode():
        ref = dec(z, f0, g=spk)
        got = dec.to(dev)(z.to(dev), f0.to(dev), g=spk.to(dev)).cpu()
    assert got.shape == ref.shape == (1, 60 * 480, 1)
    corr = float(torch.corrcoef(torch.stack([got.flatten(), ref.flatten()]).double())[0, 1])
    assert corr > 0.9999 and float((got - ref).abs().max()) < 1e-3, corr


def test_convert_batch_matches_the_host(dev):
    """BatchConverter at B = 3 on the card (K1-K4) against the host's plain
    versions, same seeded weights, source noise off: corr > 0.999 per row."""
    import numpy as np

    from rvc_tpu_torch.api import RVC
    from rvc_tpu_torch.configs import get_config
    from rvc_tpu_torch.parallel import BatchConverter

    cfg = get_config(32000, model_n_layers=1)
    batch = np.stack([_tone(1.0) * a for a in (1.0, 0.5, 0.8)])
    batch[1] = np.roll(batch[1], 4000)
    out = []
    for device in (dev, "cpu"):
        rvc = RVC(config=cfg, device=device, source_noise=False)
        out.append(BatchConverter(rvc).convert_batch(batch, np.array([0, 0, 0])))
    got, ref = out
    assert got.shape == ref.shape == (3, 32000)
    for g, r in zip(got, ref):
        assert np.corrcoef(g, r)[0, 1] > 0.999


# ----------------------------------------------------------------------------
# realtime: the shapes of one block of the default session (read_chunk_size
# 192, crossfade 0.1 s, extra 0.5 s): a 30,720-sample padded buffer, a
# 10,880-sample tail (69 mel frames), t_feat 190 frames with 113 valid


@pytest.mark.parametrize("B,lens", [(1, [113]), (16, [113] * 16)], ids=["B1", "B16"])
def test_rel_attention_realtime_block(dev, B, lens):
    g = _gen(dev, 190)
    q, k, v = (torch.randn((B, 2, 190, 96), device=dev, generator=g) for _ in range(3))
    ek, ev = (0.3 * torch.randn((1, 21, 96), device=dev, generator=g) for _ in range(2))
    key_lens = torch.tensor(lens, device=dev, dtype=torch.int32)
    got = KA.rel_attention(q, k, v, ek, ev, 10, key_lens)
    ref = KA.rel_attention(*(x.cpu() for x in (q, k, v, ek, ev)), 10, key_lens.cpu()).to(dev)
    valid = (torch.arange(190, device=dev)[None, :] < key_lens[:, None])[:, None, :, None]
    torch.testing.assert_close(got * valid, ref * valid, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("B", [1, 16])
def test_log_mel_realtime_tail(dev, B):
    audio = 0.3 * torch.randn((B, 10880), device=dev, generator=_gen(dev, B))
    got = KM.log_mel(audio)
    assert got.shape == (B, 69, 128)
    torch.testing.assert_close(got, KM.log_mel(audio.cpu()).to(dev), atol=2e-3, rtol=1e-3)


def _realtime_clip(n_blocks: int, block: int, seed: int = 0):
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(n_blocks * block) / 48000
    phase = 2 * np.pi * np.cumsum(140.0 + 40.0 * t) / 48000
    return (0.4 * np.sin(phase) + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


def test_fused_realtime_block_matches_the_host(dev):
    """The fused block path at the default session on the card (K1-K4 in
    one block program) against the port's CPU path, same seeded weights,
    noise off, 3 voiced blocks: waveform corr > 0.99 per block."""
    import numpy as np

    from rvc_tpu_torch.api import RVC
    from rvc_tpu_torch.configs import get_config
    from rvc_tpu_torch.realtime.core import VoiceChanger

    cfg = get_config(32000, model_n_layers=1)
    vcs = [VoiceChanger(RVC(config=cfg, device=d, source_noise=False), silent_threshold=-90)
           for d in (dev, "cpu")]
    block = vcs[0].block_frame
    clip = _realtime_clip(3, block)
    launches = dict(LAUNCHES)
    for i in range(3):
        b = clip[i * block: (i + 1) * block]
        got, ref = (vc.vc_model.inference(b, index_rate=0.0)[0] for vc in vcs)
        assert got.shape == ref.shape == (63 * 480,)        # return_length 63 frames
        assert np.corrcoef(got, ref)[0, 1] > 0.99
    assert all(LAUNCHES[k] > launches[k]
               for k in ("resblock_group", "resblock_chain", "rel_attention", "log_mel"))


def test_pool_matches_single_streams_on_the_card(dev):
    """VoiceChangerPool at N = 4 (one batched block program) against four
    single VoiceChangers on the card, noise off: atol 5e-3 per stream."""
    import numpy as np

    from rvc_tpu_torch.api import RVC
    from rvc_tpu_torch.configs import get_config
    from rvc_tpu_torch.realtime.core import VoiceChanger
    from rvc_tpu_torch.realtime.pool import VoiceChangerPool

    rvc = RVC(config=get_config(32000, model_n_layers=1), device=dev, source_noise=False)
    pool = VoiceChangerPool(rvc, 4, silent_threshold=-90)
    singles = [VoiceChanger(rvc, silent_threshold=-90) for _ in range(4)]
    block = pool.block_frame
    streams = np.stack([_realtime_clip(2, block, seed=s) * (0.5 + 0.1 * s) for s in range(4)])
    for i in range(2):
        blocks = streams[:, i * block: (i + 1) * block]
        pooled, _ = pool.process(blocks)
        for s in range(4):
            single, _, _ = singles[s].on_request(blocks[s], index_rate=0.0)
            np.testing.assert_allclose(pooled[s], single, rtol=0, atol=5e-3)


# --- the partial-sum launch (tensor parallelism) ---------------------------
# A rank of a model group of C // C_M on a process group of one: each step's
# all-reduce passes the rank's own partial sum on, so the kernel's chain is
# this rank's partial launches in a row, the residual and b2 in its epilogue
# on index 0 only. `_rank_chain` is that arithmetic in plain PyTorch (on
# index 0 it is `resblock_chain_partial_reference`, whose collectives pass
# through too); the two are held at K1/K2's bars. K2's sharded shape at the
# training's bucket (C = 256, C_M = 128, T = 432), K1's (C = 128, C_M = 64),
# and C_M = C / 4. The sum over a real group: `chip_smoke.py`'s `tp_gloo`.


def _rank_chain(x, w1, b1, w2, b2, k, dilations, slope, model, bf16_operands=False):
    cur = x
    for s, d in enumerate(dilations):
        cur = KR.resblock_step_partial_reference(cur, w1[s], b1[s], w2[s], b2[s], k, d, slope,
                                                 model.index == 0, bf16_operands)
    return cur


def _rank_group(x, weights, ks, dilations, slope, model, bf16_operands=False):
    outs = []
    for i, k in enumerate(ks):
        w = weights[4 * i: 4 * i + 4]
        if w[0].shape[-1] != x.shape[-1]:
            outs.append(_rank_chain(x, *w, k, dilations[i], slope, model, bf16_operands))
        else:
            outs.append(KR.resblock_chain_reference(x, *w, k, dilations[i], slope,
                                                    bf16_operands))
    return sum(outs) / len(outs)


@pytest.fixture
def one_rank(dev, tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1,
                            rank=0)
    yield
    dist.destroy_process_group()


def _shard_weights(dev, g, C, CM, K):
    return (0.01 * torch.randn((3, K, C, CM), device=dev, generator=g),
            0.1 * torch.randn((3, CM), device=dev, generator=g),
            0.01 * torch.randn((3, K, CM, C), device=dev, generator=g),
            0.1 * torch.randn((3, C), device=dev, generator=g))


@pytest.mark.parametrize("index", [0, 1])
@pytest.mark.parametrize("C,CM,K,T", [(256, 128, 11, 432), (256, 128, 3, 97),
                                      (256, 64, 7, 432), (128, 64, 11, 1001),
                                      (128, 32, 7, 4320)])
def test_resblock_chain_tp(dev, one_rank, C, CM, K, T, index):
    from rvc_tpu_torch.parallel.mesh import Axis

    g = _gen(dev, C * K + CM)
    x = torch.randn((2, T, C), device=dev, generator=g)
    ws = _shard_weights(dev, g, C, CM, K)
    model = Axis(C // CM, index)
    before = LAUNCHES["resblock_chain_tp"]
    got = KR.resblock_chain_tp(x, *ws, K, (1, 3, 5), 0.1, model)
    assert LAUNCHES["resblock_chain_tp"] == before + 3
    _assert_bf16_kernel(got, _rank_chain, x, *ws, K, (1, 3, 5), 0.1, model)
    if index == 0:
        _assert_bf16_kernel(got, KR.resblock_chain_partial_reference, x, *ws, K, (1, 3, 5),
                            0.1, model)


@pytest.mark.parametrize("index", [0, 1])
def test_resblock_group_tp(dev, one_rank, index):
    """The 48 kHz model's C = 128 stage at n_model 2: the k = 3 chain whole
    (K1's launches), k = 7 and 11 on the partial-sum launch."""
    from rvc_tpu_torch.parallel.mesh import Axis

    g = _gen(dev, 128 + index)
    x = torch.randn((2, 4320, 128), device=dev, generator=g)
    weights = _weights(dev, g, 128, 3) + _shard_weights(dev, g, 128, 64, 7) \
        + _shard_weights(dev, g, 128, 64, 11)
    ks, dil, model = (3, 7, 11), ((1, 3, 5),) * 3, Axis(2, index)
    before = dict(LAUNCHES)
    got = KR.resblock_group_tp(x, weights, ks, dil, 0.1, model)
    assert LAUNCHES["resblock_group"] == before["resblock_group"] + 3
    assert LAUNCHES["resblock_group_tp"] == before["resblock_group_tp"] + 6
    _assert_bf16_kernel(got, _rank_group, x, weights, ks, dil, 0.1, model)
    if index == 0:
        _assert_bf16_kernel(got, KR.resblock_group_partial_reference, x, weights, ks, dil, 0.1,
                            model)


def test_resblock_chain_tp_gradients(dev, one_rank):
    from rvc_tpu_torch.parallel.mesh import Axis

    g = _gen(dev, 7)
    x = torch.randn((2, 300, 256), device=dev, generator=g)
    ws = _shard_weights(dev, g, 256, 128, 7)
    got, ref, _ = _grads_both_ways(KR.resblock_chain_tp, KR.resblock_chain_partial_reference,
                                   (x, *ws), lambda w: tuple(w), 7, (1, 3, 5), 0.1, Axis(2, 0))
    for i, (a, b) in enumerate(zip(got, ref)):
        assert _rel_l2(a, b) < 1e-5, f"input {i}: rel_l2 {_rel_l2(a, b):.3g}"


def test_resblock_tp_rejects_other_shapes(dev, one_rank):
    from rvc_tpu_torch.parallel.mesh import Axis

    g = _gen(dev, 1)
    for C, CM in ((64, 32), (256, 32), (128, 128)):
        x = torch.randn((1, 50, C), device=dev, generator=g)
        with pytest.raises(ValueError, match="partial launch takes"):
            KR.resblock_chain_tp(x, *_shard_weights(dev, g, C, CM, 3), 3, (1, 3, 5), 0.1,
                                 Axis(C // CM, 0))


# --- training: K1-K3 under autograd ----------------------------------------
# The Functions' backward is the plain version's float32 autograd, re-run
# from the saved inputs: on the same upstream gradient the kernel path's
# input and weight gradients equal the plain path's up to cuDNN's summation
# order (rel_l2 < 1e-5). Their forwards stay held at the bars above.


def _grads_both_ways(fn, plain, inputs, *args):
    """(kernel path's grads, plain path's grads) of every input on one
    upstream gradient, and the kernel path's output."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(leaves[0], *args[0](leaves[1:]), *args[1:])
    g = torch.randn(out.shape, device=out.device, generator=_gen(out.device, 99))
    got = torch.autograd.grad(out, leaves, g)
    ref_leaves = [t.detach().clone().requires_grad_() for t in inputs]
    ref = torch.autograd.grad(plain(ref_leaves[0], *args[0](ref_leaves[1:]), *args[1:]),
                              ref_leaves, g)
    return got, ref, out


@pytest.mark.parametrize("C", [32, 64, 128])
def test_resblock_group_gradients(dev, C):
    g = _gen(dev, C)
    x = torch.randn((2, 700, C), device=dev, generator=g)
    weights = sum((_weights(dev, g, C, K) for K in (3, 7, 11)), ())
    ks, dil = (3, 7, 11), ((1, 3, 5),) * 3
    before = LAUNCHES["resblock_group"]
    got, ref, out = _grads_both_ways(KR.resblock_group, KR.resblock_group_reference,
                                     (x, *weights), lambda w: (tuple(w),), ks, dil)
    assert LAUNCHES["resblock_group"] == before + 9
    assert len(got) == 13
    for i, (a, b) in enumerate(zip(got, ref)):
        assert _rel_l2(a, b) < 1e-5, f"input {i}: rel_l2 {_rel_l2(a, b):.3g}"
    _assert_bf16_kernel(out.detach(), KR.resblock_group_reference, x, weights, ks, dil)


@pytest.mark.parametrize("K", [3, 7, 11])
def test_resblock_chain_gradients(dev, K):
    g = _gen(dev, K)
    x = torch.randn((2, 300, 256), device=dev, generator=g)
    ws = _weights(dev, g, 256, K)
    got, ref, _ = _grads_both_ways(KR.resblock_chain, KR.resblock_chain_reference,
                                   (x, *ws), lambda w: tuple(w), K, (1, 3, 5))
    for i, (a, b) in enumerate(zip(got, ref)):
        assert _rel_l2(a, b) < 1e-5, f"input {i}: rel_l2 {_rel_l2(a, b):.3g}"


def test_rel_attention_gradients_ragged(dev):
    """Ragged key_lens; the upstream gradient is zero on the garbage rows,
    as the TextEncoder's x_mask makes it."""
    B, H, T, D, w = 2, 2, 300, 96, 10
    g = _gen(dev, 5)
    q, k, v = (torch.randn((B, H, T, D), device=dev, generator=g) for _ in range(3))
    ek, ev = (0.3 * torch.randn((1, 2 * w + 1, D), device=dev, generator=g) for _ in range(2))
    lens = torch.tensor([300, 171], device=dev, dtype=torch.int32)
    valid = (torch.arange(T, device=dev)[None, :] < lens[:, None])[:, None, :, None].float()
    leaves = [t.clone().requires_grad_() for t in (q, k, v, ek, ev)]
    up = torch.randn((B, H, T, D), device=dev, generator=g) * valid
    got = torch.autograd.grad(KA.rel_attention(*leaves, w, lens), leaves, up)
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v, ek, ev)]
    ref = torch.autograd.grad(KA.rel_attention_reference(*ref_leaves, w, lens), ref_leaves, up)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert _rel_l2(a, b) < 1e-5, f"input {i}: rel_l2 {_rel_l2(a, b):.3g}"


def _step_losses_and_grads(cfg, net_g, net_d, batch, draws):
    """One adversarial step's losses and its G (per module) and D gradients,
    without the update."""
    from rvc_tpu_torch.train.train_step import TrainStep, make_optimizers

    g_opt, d_opt = make_optimizers(cfg, net_g, net_d)
    step = TrainStep(cfg, net_g, net_d, g_opt, d_opt)
    total, losses, y_hat, real = step.g_losses(batch, **draws)
    names = [n for n, _ in net_g.named_parameters()]
    by_module = {}
    for n, gr in zip(names, step.g_grads(total)):
        by_module.setdefault(n.split(".")[0], []).append(gr.flatten())
    d_loss = step.d_loss(real.detach(), y_hat.detach())
    by_module["D"] = [gr.flatten() for gr in torch.autograd.grad(d_loss, d_opt.params)]
    losses = {k: float(v.detach()) for k, v in losses.items()}
    losses.update(loss_d=float(d_loss.detach()), loss_g_total=float(total.detach()))
    return losses, {k: torch.cat(v).double().cpu() for k, v in by_module.items()}


def _bf16_host(monkeypatch):
    """The decoder's K1/K2 calls on host tensors take the card's arithmetic:
    their Functions with the plain version's bf16 emulation as the forward."""
    import functools

    from rvc_tpu_torch.models import generators, layers

    def group(x, weights, kernel_sizes, dilations, slope=0.1):
        return KR.GroupFunction.apply(
            functools.partial(KR.resblock_group_reference, bf16_operands=True),
            tuple(kernel_sizes), tuple(map(tuple, dilations)), slope, x, *weights)

    def chain(x, w1, b1, w2, b2, kernel_size, dilations=(1, 3, 5), slope=0.1):
        return KR.ChainFunction.apply(
            functools.partial(KR.resblock_chain_reference, bf16_operands=True),
            kernel_size, tuple(dilations), slope, x, w1, b1, w2, b2)

    monkeypatch.setattr(generators, "resblock_group", group)
    monkeypatch.setattr(layers, "resblock_chain", chain)


def test_full_width_train_step_matches_the_host(dev, monkeypatch):
    """One G+D step of the 48 kHz model at full width, batch 2, on the card
    and on the host: the same parameters, batch and draws. Against the host
    step with the card's arithmetic (K1/K2's bf16 forward emulated), each
    loss within rel 2e-2 and gradient corr > 0.99 per module; against the
    float32 host step, the losses within rel 2e-2 and corr > 0.99 for every
    module but the decoder (the bf16 forward alone moves its gradient's
    corr to ~0.98 on the host too)."""
    import copy

    import numpy as np

    from rvc_tpu_torch.configs import get_config
    from rvc_tpu_torch.models.discriminators import build_discriminator
    from rvc_tpu_torch.models.synthesizer import build_synthesizer
    from rvc_tpu_torch.train.train_step import Batch

    cfg = get_config(48000, train_batch_size=2)
    torch.manual_seed(0)
    nets = build_synthesizer(cfg, training=True), build_discriminator(cfg)
    rng = np.random.default_rng(0)
    B, T, hop = 2, 60, cfg.data.hop_length
    t = np.arange(T * hop) / 48000
    batch = Batch(torch.from_numpy(rng.standard_normal((B, T, 768)).astype(np.float32)),
                  torch.tensor([60, 50]), torch.from_numpy(rng.integers(1, 255, (B, T))),
                  torch.full((B, T), 180.0), torch.from_numpy(
                      np.abs(rng.standard_normal((B, T, 1025))).astype(np.float32)),
                  torch.tensor([60, 50]),
                  torch.from_numpy(np.stack([0.3 * np.sin(2 * np.pi * f * t)
                                             for f in (150, 220)]).astype(np.float32)),
                  torch.tensor([0, 1]))
    seg = cfg.segment_frames
    draws = dict(eps=torch.from_numpy(rng.standard_normal((B, T, 192)).astype(np.float32)),
                 ids_slice=torch.tensor([10, 3]),
                 source_noise=torch.from_numpy(
                     rng.standard_normal((B, seg * 480, 1)).astype(np.float32)))
    host = _step_losses_and_grads(cfg, *copy.deepcopy(nets), batch, draws)
    card = _step_losses_and_grads(cfg, *(n.to(dev) for n in nets), batch.to(dev),
                                  {k: v.to(dev) for k, v in draws.items()})
    _bf16_host(monkeypatch)
    host_bf16 = _step_losses_and_grads(cfg, *(n.cpu() for n in nets), batch, draws)
    for ref, modules in ((host_bf16, ("enc_p", "enc_q", "flow", "dec", "D")),
                         (host, ("enc_p", "enc_q", "flow", "D"))):
        for k, v in ref[0].items():
            assert card[0][k] == pytest.approx(v, rel=2e-2), (k, card[0][k], v)
        for k in modules:
            corr = float(torch.corrcoef(torch.stack([card[1][k], ref[1][k]]))[0, 1])
            assert corr > 0.99, (k, corr)


def test_nccl_world_size_one_step_matches_the_single_card(dev, tmp_path):
    """The data-parallel trainer at world size 1, joined by NCCL through
    `parallel.distributed.initialize` (a localhost coordinator), against
    the single-card trainer: two steps at the 48 kHz decoder's width, batch
    2, the same seed (init and draws). An all-reduce over one rank and the
    batch's own rows change nothing, but cuDNN's backward is not
    deterministic from run to run (the gradient norm moved by rel 3.4e-5
    between two runs on the card), so the bars are `chip_smoke.py`'s
    `ddp_gloo` ones: step 1's losses within rel 1e-4, G and D after the
    steps within rel_l2 1e-3 over each network, every metric finite."""
    import numpy as np
    import torch.distributed as dist

    from rvc_tpu_torch.configs import get_config
    from rvc_tpu_torch.monitoring import NullTracker
    from rvc_tpu_torch.parallel.distributed import initialize
    from rvc_tpu_torch.parallel.mesh import make_mesh
    from rvc_tpu_torch.parallel.train import free_port
    from rvc_tpu_torch.train.data import DataLoader, RVCDataset
    from rvc_tpu_torch.train.train_step import Batch
    from rvc_tpu_torch.train.trainer import RVCTrainer

    cfg = get_config(48000, model_spk_embed_dim=2, model_n_layers=1, train_batch_size=2)
    rng = np.random.default_rng(1)
    B, T, hop = 2, 60, cfg.data.hop_length
    t = np.arange(T * hop) / 48000
    batch = Batch(torch.from_numpy(rng.standard_normal((B, T, 768)).astype(np.float32)),
                  torch.tensor([60, 50]), torch.from_numpy(rng.integers(1, 255, (B, T))),
                  torch.full((B, T), 180.0), torch.from_numpy(
                      np.abs(rng.standard_normal((B, T, 1025))).astype(np.float32)),
                  torch.tensor([60, 50]),
                  torch.from_numpy(np.stack([0.3 * np.sin(2 * np.pi * f * t)
                                             for f in (150, 220)]).astype(np.float32)),
                  torch.tensor([0, 1])).to(dev)

    def run(mesh):
        tr = RVCTrainer(cfg, DataLoader(RVCDataset([], hop), 1), checkpoint_dir=str(tmp_path),
                        seed=0, tracker=NullTracker(), mesh=mesh, device=dev)
        step = tr.step_fn(True)
        metrics = [{k: float(v) for k, v in step(batch, tr.generator).items()}
                   for _ in range(2)]
        return metrics, tr

    single, ref = run(None)
    info = initialize(f"localhost:{free_port()}", 1, 0)
    try:
        assert info["backend"] == "nccl" and info["process_count"] == 1
        got, tr = run(make_mesh())
        assert type(tr.step_fn(True)).__name__ == "DataParallelTrainStep"
    finally:
        dist.destroy_process_group()
    assert all(np.isfinite(v) for m in got for v in m.values())
    for k, v in single[0].items():
        if k.startswith("loss"):
            assert got[0][k] == pytest.approx(v, rel=1e-4), k
    for name in ("net_g", "net_d"):
        a, b = getattr(tr, name).state_dict(), getattr(ref, name).state_dict()
        a, b = (torch.cat([x[k].double().flatten() for k in b]) for x in (a, b))
        assert float((a - b).norm() / b.norm()) < 1e-3, name
