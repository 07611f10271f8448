"""The slice as a whole: the port's offline pipeline against the JAX
`Pipeline` (fused RMVPE path) on the same small models and the same clip."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from rvc_tpu import retrieval as JR
from rvc_tpu.pipelines.offline import Pipeline as JaxPipeline
from rvc_tpu.pitch import PitchExtractor
from rvc_tpu_torch import retrieval as PR
from rvc_tpu_torch.pipelines.offline import Pipeline
from torch_port_helpers import huberts, rmvpes, synthesizers

SR = 32000
UPS_GAIN = 20.0   # see torch_port_helpers.synthesizers


def _pipelines(use_f0: bool, ups_gain: float = 1.0):
    port_s, jax_s, s_params = synthesizers(use_f0=use_f0, ups_gain=ups_gain)
    port_h, jax_h, h_params = huberts()
    port_r, jax_r, r_vars = rmvpes()
    pitch = PitchExtractor("rmvpe", model=SimpleNamespace(model=jax_r, variables=r_vars))
    ref = JaxPipeline(tgt_sr=SR, synthesizer=jax_s, synth_variables={"params": s_params},
                      hubert=jax_h, hubert_variables={"params": h_params},
                      pitch_extractor=pitch)
    return ref, Pipeline(SR, port_s, port_h, port_r, source_noise=False)


@pytest.fixture(scope="module")
def pipelines():
    return _pipelines(use_f0=True)


@pytest.fixture(scope="module")
def indexes():
    """(JAX index, port index) of the same arrays: IVFFlat over the small
    HuBERT's features of six chirps that start 10-60 Hz above the test
    clips', so a clip's frames fall near stored vectors but on none."""
    port_h = huberts()[0]
    with torch.inference_mode():
        feats = np.concatenate([port_h(torch.from_numpy(_clip(1.0, seed=s, f_start=140 + 10 * s))
                                       [None])[0].numpy() for s in range(1, 7)])
    ref = JR.build_index(feats, seed=0)
    return ref, PR.IVFFlatIndex(centroids=ref.centroids.copy(), vectors=ref.vectors.copy(),
                                list_ids=ref.list_ids.copy(), nprobe=ref.nprobe)


def _clip(seconds=0.9, seed=0, f_start=140.0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    phase = 2 * np.pi * (f_start * t + 60 * t * t)
    return (0.5 * np.sin(phase) + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


@pytest.mark.parametrize("kw", [dict(), dict(pitch_shift=2.0, protect=0.33,
                                            f0_autotune=True, f0_autotune_strength=0.5)],
                         ids=["defaults", "shift+protect+autotune"])
def test_pipeline_matches_jax(pipelines, monkeypatch, kw):
    """Source noise off and f32 transfers on the JAX side (its programs
    read these when first built). Bar: waveform corr > 0.995, same length."""
    monkeypatch.setenv("RVC_TPU_SOURCE_NOISE", "0")
    monkeypatch.setenv("RVC_TPU_F16_IN", "0")
    monkeypatch.setenv("RVC_TPU_F16_OUT", "0")
    ref_pipe, port_pipe = pipelines
    clip = _clip()
    ref = ref_pipe.pipeline(clip, sid=1, f0_method="rmvpe", index=None, index_rate=0.0, **kw)
    got = port_pipe.pipeline(clip, sid=1, **kw)
    assert got.shape == ref.shape == (int(0.9 * SR),)
    corr = np.corrcoef(got, ref)[0, 1]
    assert corr > 0.995, f"waveform corr {corr:.6f}"


def test_pipeline_with_index_matches_jax(indexes, monkeypatch):
    """Retrieval at index_rate 0.75 with the protect blend (0.33) toward the
    pre-retrieval features, on the fused path: waveform corr > 0.995. The
    decoder's upsampling weights are scaled up so that the waveform follows
    the features, not only the sine source."""
    monkeypatch.setenv("RVC_TPU_SOURCE_NOISE", "0")
    monkeypatch.setenv("RVC_TPU_F16_IN", "0")
    monkeypatch.setenv("RVC_TPU_F16_OUT", "0")
    ref_pipe, port_pipe = _pipelines(use_f0=True, ups_gain=UPS_GAIN)
    jax_index, port_index = indexes
    clip = _clip()
    kw = dict(sid=1, index_rate=0.75, protect=0.33)
    ref = ref_pipe.pipeline(clip, f0_method="rmvpe", index=jax_index, **kw)
    got = port_pipe.pipeline(clip, index=port_index, **kw)
    plain = port_pipe.pipeline(clip, **kw)
    assert got.shape == ref.shape == (int(0.9 * SR),)
    corr = np.corrcoef(got, ref)[0, 1]
    assert corr > 0.995, f"waveform corr {corr:.6f}"
    assert np.corrcoef(got, plain)[0, 1] < 0.999  # retrieval moved the output


@pytest.mark.parametrize("with_index", [False, True], ids=["no-index", "index"])
def test_f0less_staged_path_matches_jax(indexes, monkeypatch, with_index):
    """An f0-less model through both staged paths (no pitch, host trim of
    pad_tgt): the same length, waveform corr > 0.995."""
    monkeypatch.setenv("RVC_TPU_F16_IN", "0")
    ref_pipe, port_pipe = _pipelines(use_f0=False, ups_gain=UPS_GAIN)
    jax_index, port_index = indexes if with_index else (None, None)
    clip = _clip(1.3, seed=7)
    ref = ref_pipe.pipeline(clip, sid=1, index=jax_index, index_rate=0.75, pitch_guidance=False)
    got = port_pipe.pipeline(clip, sid=1, index=port_index, index_rate=0.75,
                             pitch_guidance=False)
    assert got.shape == ref.shape == (int(1.3 * SR),)
    corr = np.corrcoef(got, ref)[0, 1]
    assert corr > 0.995, f"waveform corr {corr:.6f}"
    if with_index:  # retrieval moved the output
        plain = port_pipe.pipeline(clip, sid=1, pitch_guidance=False)
        assert np.corrcoef(got, plain)[0, 1] < 0.999


@pytest.mark.parametrize("kw,error", [
    (dict(pitch_guidance=False), ValueError),
], ids=["f0-model-without-pitch"])
def test_paths_not_ported_raise(pipelines, kw, error):
    with pytest.raises(error):
        pipelines[1].pipeline(_clip(0.3), **kw)


def test_f0_program_matches(pipelines, monkeypatch):
    """The f0 program alone (log-mel -> RMVPE -> decode -> gates) on a
    bucket-padded chunk: the same Hz on both sides (rtol 1e-4)."""
    monkeypatch.setenv("RVC_TPU_F16_IN", "0")
    ref_pipe, port_pipe = pipelines
    audio = np.pad(_clip(1.0, seed=3), (0, 15360 * 2 - 16000), mode="reflect")[None]
    import jax.numpy as jnp

    ref_pipe._rmvpe_model = ref_pipe._get_rmvpe().model
    ref = np.asarray(ref_pipe._build_f0_program()(
        ref_pipe._get_rmvpe().variables, jnp.asarray(audio), jnp.float32(0.0),
        jnp.float32(0.0)))
    with torch.inference_mode():
        got = port_pipe.f0(torch.from_numpy(audio), 0.0, 0.0).numpy()
    assert (got > 0).mean() > 0.5  # the random small RMVPE still calls most frames voiced
    np.testing.assert_allclose(got, ref, rtol=1e-4)


def test_entry_point_refuses_cpu_fallback(monkeypatch):
    """With no GPU and no explicit device="cpu", the entry point raises."""
    from rvc_tpu_torch.api import RVC

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RVC()


def test_rvc_loads_port_state_and_converts_a_file(tmp_path):
    """RVC takes port state dicts (strict) and converts a WAV file on the
    CPU path; the output is the clip's length at the model's rate."""
    from rvc_tpu_torch.api import RVC
    from rvc_tpu_torch.configs import get_config
    from rvc_tpu_torch.utils import audio as audio_utils
    from torch_port_helpers import SMALL_SYNTH_ARGS

    port_s, _, _ = synthesizers()
    cfg = get_config(32000, **{k: v for k, v in SMALL_SYNTH_ARGS.items()
                               if k != "model_text_enc_hidden_dim"})
    rvc = RVC(config=cfg, device="cpu", synthesizer_state={
        k: v for k, v in port_s.state_dict().items() if not k.startswith("enc_p.emb_phone")}
        | {"enc_p.emb_phone.weight": torch.zeros(32, 768),
           "enc_p.emb_phone.bias": torch.zeros(32)})
    np.testing.assert_array_equal(rvc.pipeline.synthesizer.dec.conv_post.weight.numpy(),
                                  port_s.dec.conv_post.weight.detach().numpy())
    audio_utils.save_wav(str(tmp_path / "in.wav"), _clip(0.5), 16000)
    rvc.infer_file(str(tmp_path / "in.wav"), str(tmp_path / "out.wav"))
    out, sr = audio_utils.load_wav(str(tmp_path / "out.wav"))
    assert sr == SR and out.shape == (SR // 2,) and np.isfinite(out).all()


@pytest.mark.parametrize("seconds", [40.0, 100.0])
def test_chunk_bounds_match(pipelines, monkeypatch, seconds):
    """Long clips split at the same minimum-energy points (the reference's
    default chunking, no RVC_TPU_CHUNK_S)."""
    monkeypatch.delenv("RVC_TPU_CHUNK_S", raising=False)
    ref_pipe, port_pipe = pipelines
    audio = _clip(seconds, seed=4) * np.random.default_rng(5).uniform(
        0, 1, int(seconds * 16000)).astype(np.float32)
    assert port_pipe.chunk_bounds(audio) == ref_pipe.chunk_bounds(audio)
    assert len(port_pipe.chunk_bounds(audio)) == (1 if seconds <= 41 else 3)


def test_record_calls_replays_the_kernel_calls_of_a_conversion(pipelines):
    """`record_calls` keeps one copy of every kernel-wrapper call a
    conversion makes (how `chip_smoke.py` times the main path's calls);
    each replays to the same output through its plain version, and a
    replay records nothing."""
    from rvc_tpu_torch.ops.kernels import attention as KA
    from rvc_tpu_torch.ops.kernels import melspec as KM
    from rvc_tpu_torch.ops.kernels import record_calls
    from rvc_tpu_torch.ops.kernels import resblock as KR

    _, port_pipe = pipelines
    with record_calls() as calls:
        port_pipe.pipeline(_clip(0.5), sid=1)
    names = [fn.__name__ for fn, _, _ in calls]
    dec = port_pipe.synthesizer.dec
    assert names.count("log_mel") == 1
    assert names.count("rel_attention") == len(port_pipe.synthesizer.enc_p.encoder.attn_layers)
    assert names.count("resblock_group") == len(dec.ups)  # every stage is C <= 128 here
    with record_calls() as replays, torch.inference_mode():
        for fn, args, kwargs in calls:
            module = {"log_mel": KM, "rel_attention": KA}.get(fn.__name__, KR)
            plain = getattr(module, fn.__name__ + "_reference")
            torch.testing.assert_close(fn(*args, **kwargs), plain(*args, **kwargs),
                                       rtol=0, atol=0)
    assert replays == []
