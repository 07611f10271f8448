"""The staged path with pitch: the port's `Pipeline` against the JAX
`Pipeline` for every pitch method, `input_f0` (over several chunks),
`proposed_pitch`, CREPE's hop and autotune, on the same small models and
clips. Bar: waveform corr > 0.995 with the same length. Source noise is
off on both sides."""

import numpy as np
import pytest
import torch

from rvc_tpu.configs import PipelineConfig as JaxPipelineConfig
from rvc_tpu.models import crepe as JC
from rvc_tpu.models import fcpe as JF
from rvc_tpu.models.rmvpe import E2E as JaxE2E, RMVPE as JaxRMVPE
from rvc_tpu.pipelines.offline import Pipeline as JaxPipeline
from rvc_tpu.pitch import PitchExtractor as JaxPitchExtractor
from rvc_tpu.utils import weights as JW
from rvc_tpu_torch.configs import PipelineConfig
from rvc_tpu_torch.models import crepe as PC
from rvc_tpu_torch.models import fcpe as PF
from rvc_tpu_torch.ops.kernels import record_calls
from rvc_tpu_torch.pipelines.offline import Pipeline
from rvc_tpu_torch.pitch import PitchExtractor
from torch_port_helpers import SMALL_RMVPE, huberts, numpy_state, rmvpes, synthesizers

SR = 32000


@pytest.fixture(autouse=True)
def no_source_noise(monkeypatch):
    """The JAX programs read these when they first trace."""
    monkeypatch.setenv("RVC_TPU_SOURCE_NOISE", "0")
    monkeypatch.setenv("RVC_TPU_F16_IN", "0")
    monkeypatch.setenv("RVC_TPU_F16_OUT", "0")
    monkeypatch.delenv("RVC_TPU_CHUNK_S", raising=False)


def _pipelines(config=None):
    port_s, jax_s, s_params = synthesizers()
    port_h, jax_h, h_params = huberts()
    port_r = rmvpes()[0]
    ref = JaxPipeline(tgt_sr=SR, synthesizer=jax_s, synth_variables={"params": s_params},
                      hubert=jax_h, hubert_variables={"params": h_params},
                      config=JaxPipelineConfig(**config) if config else None)
    port = Pipeline(SR, port_s, port_h, port_r,
                    config=PipelineConfig(**config) if config else None)
    return ref, port


@pytest.fixture(scope="module")
def pipelines():
    """One pair for the module: the JAX programs compile once."""
    return _pipelines()


@pytest.fixture(scope="module")
def models():
    """Small CREPE tiny, FCPE (2 x 64) and RMVPE, each as (port predictor,
    JAX predictor) with the same weights."""
    torch.manual_seed(3)
    crepe = PC.CREPEModel("tiny").eval()
    params, stats = JW.convert_crepe_state_dict(numpy_state(crepe))
    torch.manual_seed(5)
    fcpe = PF.FCPEModel(n_layers=2, n_chans=64, generator=torch.Generator().manual_seed(5))
    jax_fcpe = JF.FCPE(params=JW.convert_fcpe_state_dict(numpy_state(fcpe)))
    jax_fcpe.model = JF.FCPEModel(n_layers=2, n_chans=64)   # read when its jit traces
    variables = rmvpes()[2]
    jax_rmvpe = JaxRMVPE(params=variables["params"], batch_stats=variables["batch_stats"])
    jax_rmvpe.model = JaxE2E(**SMALL_RMVPE)
    return {"crepe-tiny": (PC.CREPE(model=crepe),
                           JC.CREPE("tiny", params=params, batch_stats=stats)),
            "fcpe": (PF.FCPE(model=fcpe.eval()), jax_fcpe),
            "rmvpe": (None, jax_rmvpe)}


def _clip(seconds=0.9, seed=0, f_start=140.0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    phase = 2 * np.pi * (f_start * t + 60 * t * t)
    return (0.5 * np.sin(phase) + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


def _extractors(pipelines, models, method, hop=160):
    """Give both pipelines `method`'s extractor over the same weights; the
    port's rmvpe is the pipeline's own E2E."""
    ref_pipe, port_pipe = pipelines
    port_model, jax_model = models.get(method, (None, None))
    ref_pipe.pitch_extractor = JaxPitchExtractor(method, model=jax_model, crepe_hop=hop)
    port_pipe.pitch_extractor = None if method == "rmvpe" else PitchExtractor(
        method, model=port_model, crepe_hop=hop, device="cpu")


def _assert_same_audio(got, ref, seconds):
    assert got.shape == ref.shape == (int(seconds * SR),)
    corr = np.corrcoef(got, ref)[0, 1]
    assert corr > 0.995, f"waveform corr {corr:.6f}"


CASES = {
    "crepe-tiny": dict(f0_method="crepe-tiny"),
    "crepe-tiny-hop320": dict(f0_method="crepe-tiny", f0_hop_length=320),
    "fcpe": dict(f0_method="fcpe"),
    "pm": dict(f0_method="pm"),
    "dio": dict(f0_method="dio"),
    "harvest": dict(f0_method="harvest"),
    "hybrid": dict(f0_method="hybrid[pm+dio+harvest]"),
    "pm+autotune+shift": dict(f0_method="pm", f0_autotune=True, f0_autotune_strength=0.5,
                              pitch_shift=2.0, protect=0.33),
    "rmvpe+proposed_pitch": dict(f0_method="rmvpe", proposed_pitch=True,
                                 proposed_pitch_threshold=220.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_staged_pitch_matches_jax(pipelines, models, case):
    kw = CASES[case]
    _extractors(pipelines, models, kw["f0_method"], kw.get("f0_hop_length", 160))
    ref_pipe, port_pipe = pipelines
    clip = _clip()
    ref = ref_pipe.pipeline(clip, sid=1, index=None, index_rate=0.0, **kw)
    got = port_pipe.pipeline(clip, sid=1, **kw)
    _assert_same_audio(got, ref, 0.9)
    method = kw["f0_method"]
    if method != "rmvpe":   # the extractor was kept: same method and hop
        assert port_pipe.pitch_extractor.method == method


def test_staged_paths_launch_k4_only_for_rmvpe(pipelines, models):
    """RMVPE staged (proposed_pitch) runs log-mel through the K4 wrapper,
    once a chunk; CREPE does not; both run K1-K3's wrappers."""
    _, port_pipe = pipelines
    for kw, mels in ((CASES["rmvpe+proposed_pitch"], 1), (CASES["crepe-tiny"], 0)):
        _extractors(pipelines, models, kw["f0_method"])
        with record_calls() as calls:
            port_pipe.pipeline(_clip(0.5), sid=1, **kw)
        names = [fn.__name__ for fn, _, _ in calls]
        assert names.count("log_mel") == mels
        assert names.count("rel_attention") == len(port_pipe.synthesizer.enc_p.encoder.attn_layers)
        assert names.count("resblock_group") == len(port_pipe.synthesizer.dec.ups)


def test_proposed_pitch_moves_the_pitch(pipelines, models):
    """A threshold an octave up shifts the output's f0 (12 semitones at
    most), so the waveform changes; rmvpe without it stays on the fused path."""
    _extractors(pipelines, models, "rmvpe")
    _, port_pipe = pipelines
    clip = _clip()
    fused = port_pipe.pipeline(clip, sid=1)
    low = port_pipe.pipeline(clip, sid=1, proposed_pitch=True, proposed_pitch_threshold=100.0)
    high = port_pipe.pipeline(clip, sid=1, proposed_pitch=True, proposed_pitch_threshold=400.0)
    assert np.corrcoef(low, high)[0, 1] < 0.9 and np.corrcoef(fused, high)[0, 1] < 0.9


@pytest.mark.parametrize("seconds,config", [
    (0.9, None),
    (5.0, dict(x_pad=1, x_query=1, x_center=2, x_max=3)),
], ids=["one-chunk", "three-chunks"])
def test_input_f0_matches_jax(seconds, config, pipelines):
    """A user's f0 curve (one value per 10 ms of the clip, unvoiced runs
    included), padded once and sliced per chunk on both sides."""
    ref_pipe, port_pipe = pipelines if config is None else _pipelines(config)
    clip = _clip(seconds, seed=2)
    n = int(seconds * 100)
    f0 = (150.0 + 50.0 * np.sin(np.arange(n) / 40.0)).astype(np.float32)
    f0[n // 3: n // 3 + 20] = 0.0
    bounds = port_pipe.chunk_bounds(clip)
    assert bounds == ref_pipe.chunk_bounds(clip) and len(bounds) == (1 if config is None else 3)
    ref = ref_pipe.pipeline(clip, sid=1, index=None, index_rate=0.0, input_f0=f0, pitch_shift=1.0)
    got = port_pipe.pipeline(clip, sid=1, input_f0=f0, pitch_shift=1.0)
    _assert_same_audio(got, ref, seconds)


def test_input_f0_slices_per_chunk(pipelines):
    """Each chunk's get_f0 receives the curve's window of its padded
    chunk: edge-padded by t_pad // 160 frames, offset by the chunk start."""
    port_pipe = _pipelines(dict(x_pad=1, x_query=1, x_center=2, x_max=3))[1]
    clip = _clip(5.0, seed=2)
    f0 = np.arange(500, dtype=np.float32) + 100.0
    seen = []

    def get_f0(x, p_len, *args):
        seen.append((len(x), p_len, args[4].copy()))
        return np.zeros(p_len, np.int32) + 1, np.zeros(p_len, np.float32)

    port_pipe.get_f0 = get_f0
    port_pipe.pipeline(clip, sid=1, input_f0=f0)
    pw = port_pipe.t_pad // 160
    padded = np.pad(f0, (pw, pw), mode="edge")
    bounds = port_pipe.chunk_bounds(clip)
    assert len(seen) == len(bounds) == 3
    for (s, e), (n, p_len, chunk_f0) in zip(bounds, seen):
        assert n == e - s + 2 * port_pipe.t_pad and p_len == n // 160
        np.testing.assert_array_equal(chunk_f0, padded[s // 160: (e + 2 * port_pipe.t_pad) // 160])


def test_extractor_is_made_anew_on_a_new_method_or_hop(pipelines):
    _, port_pipe = pipelines
    port_pipe.pitch_extractor = None
    x = _clip(0.5)
    port_pipe.get_f0(x, 50, "pm")
    first = port_pipe.pitch_extractor
    port_pipe.get_f0(x, 50, "pm")
    assert port_pipe.pitch_extractor is first
    port_pipe.get_f0(x, 50, "pm", f0_hop_length=320)
    assert port_pipe.pitch_extractor is not first and port_pipe.pitch_extractor.crepe_hop == 320
    port_pipe.get_f0(x, 50, "rmvpe")
    assert port_pipe.pitch_extractor._model.model is port_pipe.rmvpe


@pytest.mark.parametrize("kw", [dict(f0_method="pm"), dict(f0_method="pm", proposed_pitch=True),
                                dict(f0_method="pm", f0_autotune=True, pitch_shift=-3.0),
                                dict(input_f0=np.full(30, 180.0, np.float32))],
                         ids=["pm", "proposed", "autotune", "input_f0-short"])
def test_get_f0_matches_jax(pipelines, kw):
    """get_f0 alone: the same coarse bins and Hz; a short input_f0 is
    padded with zeros to p_len."""
    ref_pipe, port_pipe = pipelines
    ref_pipe.pitch_extractor = port_pipe.pitch_extractor = None
    x = _clip(0.6, seed=9)
    args = (x, 60, kw.pop("f0_method", "rmvpe"), kw.pop("pitch_shift", 0.0),
            kw.pop("f0_autotune", False), 1.0, kw.pop("input_f0", None),
            kw.pop("proposed_pitch", False))
    coarse, f0 = port_pipe.get_f0(*args)
    coarse_ref, f0_ref = ref_pipe.get_f0(*args)
    assert coarse.dtype == np.int32 and f0.dtype == np.float32 and f0.shape == (60,)
    np.testing.assert_array_equal(coarse, coarse_ref)
    np.testing.assert_array_equal(f0, f0_ref)
