"""The MRF HiFi-GAN and RefineGAN vocoders (`models/generators_extra.py`)
against the JAX package's: their building blocks, the decoders alone
(small widths: c = 64, rates (10, 8, 2, 2); ROADMAP's per-module bar, RMSE <
0.01 and corr > 0.99), `Synthesizer.infer` and the fused `Pipeline` (corr >
0.995), and their weights both ways. Noise is off on both sides."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_tpu.configs import get_config
from rvc_tpu.models import generators_extra as JG
from rvc_tpu.pipelines.offline import Pipeline as JaxPipeline
from rvc_tpu.pitch import PitchExtractor as JaxPitchExtractor
from rvc_tpu.utils import weights as W
from rvc_tpu_torch import api as port_api
from rvc_tpu_torch.configs import config_to_dict
from rvc_tpu_torch.configs import get_config as port_get_config
from rvc_tpu_torch.models import generators_extra as PG
from rvc_tpu_torch.models.synthesizer import build_synthesizer
from rvc_tpu_torch.ops.kernels import record_calls
from rvc_tpu_torch.pipelines.offline import Pipeline, coarse_f0
from rvc_tpu_torch.utils import weights as PW
from torch_port_helpers import (SMALL_SYNTH_ARGS, assert_parity, huberts, rmvpes, stats,
                                synthesizers)

SR = 32000
VOCODERS = ["MRF HiFi-GAN", "RefineGAN"]
DECODERS = {"MRF HiFi-GAN": PG.HiFiGANMRFGenerator, "RefineGAN": PG.RefineGANGenerator}


def _f0(T, seed=0):
    """Frame f0 (1, T) in Hz with an unvoiced run."""
    f0 = 150.0 + 60.0 * np.sin(np.arange(T) / 5.0 + seed)
    f0[T // 3: T // 3 + 6] = 0.0
    return f0.astype(np.float32)[None]


def test_audio_rate_sines_match_jax():
    """Harmonics 0-8 at 32 kHz over 24,000 samples (the float32 phase
    cumsum), voiced and unvoiced, noise off."""
    f0_up = np.repeat(_f0(75, seed=1), 320, axis=1)[:, :, None] * 2.5
    ref = np.asarray(JG.audio_rate_sines(jnp.asarray(f0_up), SR, 8))
    got = PG.audio_rate_sines(torch.from_numpy(f0_up), SR, 8).numpy()
    assert got.shape == ref.shape == (1, 24000, 9)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)


def test_audio_rate_sines_noise_comes_from_the_generator():
    f0 = torch.from_numpy(np.repeat(_f0(20), 100, axis=1)[:, :, None])
    a, b = (PG.audio_rate_sines(f0, SR, 8, generator=torch.Generator().manual_seed(7))
            for _ in range(2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    quiet = PG.audio_rate_sines(f0, SR, 8)
    assert 0.001 < float((a - quiet).abs().mean()) < 0.1    # a noise floor, not a new signal


@pytest.mark.parametrize("factor,T", [(2, 1000), (10, 995), (12, 1001)])
def test_kaiser_sinc_decimate_matches_jax(factor, T):
    """The depthwise strided lowpass (2 * 64 * factor + 1 taps), T not a
    multiple of the factor: ceil(T / factor) samples out."""
    x = np.random.default_rng(factor).standard_normal((2, T, 3)).astype(np.float32)
    ref = np.asarray(JG.kaiser_sinc_decimate(jnp.asarray(x), factor))
    got = PG.kaiser_sinc_decimate(torch.from_numpy(x), factor).numpy()
    assert got.shape == ref.shape == (2, -(-T // factor), 3)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("T,new_t", [(7, 17), (50, 600), (40, 80), (5, 5)])
def test_linear_resize_matches_jax(T, new_t):
    """jax.image.resize(linear) upsampling, integer and non-integer ratios,
    the first and last samples included."""
    x = np.random.default_rng(T).standard_normal((2, T, 3)).astype(np.float32)
    ref = np.asarray(JG.linear_resize(jnp.asarray(x), new_t))
    got = PG.linear_resize(torch.from_numpy(x), new_t).numpy()
    assert got.shape == ref.shape == (2, new_t, 3)
    np.testing.assert_allclose(got[:, [0, -1]], ref[:, [0, -1]], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)


def test_linear_resize_refuses_to_downsample():
    with pytest.raises(ValueError):
        PG.linear_resize(torch.zeros(1, 10, 1), 5)


def _inputs(T=40, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((2, T, 16)).astype(np.float32)
    g = rng.standard_normal((2, 1, 16)).astype(np.float32)
    f0 = np.concatenate([_f0(T, seed), _f0(T, seed + 2) * 1.3])
    return z, f0, g


@pytest.mark.parametrize("vocoder", VOCODERS)
def test_decoder_matches_jax(vocoder):
    port, jax_s, params = synthesizers(vocoder=vocoder)
    assert isinstance(port.dec, DECODERS[vocoder])
    z, f0, g = _inputs()
    ref = np.asarray(jax_s.apply({"params": params}, jnp.asarray(z), jnp.asarray(f0),
                                 jnp.asarray(g), method=lambda m, z, f0, g: m.dec(z, f0, g=g)))
    with torch.inference_mode():
        got = port.dec(torch.from_numpy(z), torch.from_numpy(f0), g=torch.from_numpy(g)).numpy()
    assert got.shape == ref.shape == (2, 40 * 320, 1)
    assert_parity(got, ref, f"{vocoder} decoder")
    assert np.abs(ref).max() > 1e-4


@pytest.mark.parametrize("vocoder", VOCODERS)
def test_synthesizer_infer_matches_jax(vocoder):
    port, jax_s, params = synthesizers(vocoder=vocoder)
    rng = np.random.default_rng(3)
    T = 36
    phone = rng.standard_normal((2, T, 32)).astype(np.float32)
    f0 = np.concatenate([_f0(T), _f0(T, 4) * 0.8])
    lengths, sid = np.array([T, T - 5]), np.array([1, 0])
    ref, _ = jax_s.apply({"params": params}, jnp.asarray(phone), jnp.asarray(lengths),
                         jnp.asarray(coarse_f0(f0)), jnp.asarray(f0), jnp.asarray(sid),
                         method=jax_s.infer)
    with torch.inference_mode():
        got, _ = port.infer(torch.from_numpy(phone), torch.from_numpy(lengths),
                            torch.from_numpy(coarse_f0(f0)).long(), torch.from_numpy(f0),
                            torch.from_numpy(sid))
    _, corr = stats(got.numpy(), np.asarray(ref))
    assert got.shape == ref.shape and corr > 0.995, f"corr {corr:.6f}"


def _clip(seconds=0.9, seed=0, f_start=140.0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    phase = 2 * np.pi * (f_start * t + 60 * t * t)
    return (0.5 * np.sin(phase) + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


@pytest.mark.parametrize("vocoder", VOCODERS)
def test_pipeline_matches_jax(vocoder, monkeypatch):
    """The fused RMVPE path with each vocoder: waveform corr > 0.995, and
    the kernel wrappers called are K3 and K4 only (the vocoders reach no
    ResBlock kernel, as in the reference)."""
    monkeypatch.setenv("RVC_TPU_SOURCE_NOISE", "0")
    monkeypatch.setenv("RVC_TPU_F16_IN", "0")
    monkeypatch.setenv("RVC_TPU_F16_OUT", "0")
    port_s, jax_s, s_params = synthesizers(vocoder=vocoder)
    port_h, jax_h, h_params = huberts()
    port_r, jax_r, r_vars = rmvpes()
    pitch = JaxPitchExtractor("rmvpe", model=SimpleNamespace(model=jax_r, variables=r_vars))
    ref_pipe = JaxPipeline(tgt_sr=SR, synthesizer=jax_s, synth_variables={"params": s_params},
                           hubert=jax_h, hubert_variables={"params": h_params},
                           pitch_extractor=pitch)
    port_pipe = Pipeline(SR, port_s, port_h, port_r)
    clip = _clip()
    ref = ref_pipe.pipeline(clip, sid=1, f0_method="rmvpe", index=None, index_rate=0.0)
    with record_calls() as calls:
        got = port_pipe.pipeline(clip, sid=1)
    names = sorted({fn.__name__ for fn, _, _ in calls})
    assert names == ["log_mel", "rel_attention"]
    _, corr = stats(got, ref)
    assert got.shape == ref.shape == (int(0.9 * SR),) and corr > 0.995, f"corr {corr:.6f}"


def _jax_params(vocoder):
    """The small JAX synthesizer's inference parameter tree, as its init
    lays it out (`jax.eval_shape`, nothing compiled), filled from a seed."""
    from rvc_tpu.models.synthesizer import build_synthesizer as jax_build

    T = 12
    shapes = jax.eval_shape(lambda: jax_build(
        get_config(32000, **SMALL_SYNTH_ARGS, model_vocoder=vocoder)).init(
        {"params": jax.random.PRNGKey(1)}, jnp.zeros((1, T, 32)), jnp.array([T]),
        jnp.zeros((1, T), jnp.int32), jnp.full((1, T), 200.0), jnp.array([0]),
        method="infer"))["params"]
    rng = np.random.default_rng(1)
    return jax.tree_util.tree_map(
        lambda s: (0.05 * rng.standard_normal(s.shape)).astype(np.float32), shapes)


@pytest.mark.parametrize("vocoder", VOCODERS)
def test_jax_params_load_strict(vocoder, tmp_path, monkeypatch):
    """The JAX init's parameters map onto the port's model with
    strict=True, and as a .safetensors with its .json sidecar (the port's
    writer) they load through RVC(model_path=...) with that decoder."""
    params = _jax_params(vocoder)
    sd = PW.synthesizer_from_jax(params)
    model = build_synthesizer(port_get_config(32000, **SMALL_SYNTH_ARGS, model_vocoder=vocoder))
    model.load_state_dict(sd, strict=True)
    monkeypatch.setenv("RVC_TPU_MODELS_DIR", str(tmp_path / "models"))
    path = str(tmp_path / "model.safetensors")
    PW.save_params(params, path, config=config_to_dict(
        port_get_config(32000, **SMALL_SYNTH_ARGS, model_vocoder=vocoder)))
    rvc = port_api.RVC(model_path=path, device="cpu")
    assert rvc.cfg.model.vocoder == vocoder
    assert isinstance(rvc.pipeline.synthesizer.dec, DECODERS[vocoder])
    for k, v in rvc.pipeline.synthesizer.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k].numpy(), err_msg=k)


@pytest.mark.parametrize("vocoder", VOCODERS)
def test_port_export_pth_reads_as_the_jax_loader_does(vocoder, tmp_path):
    """The port's .pth writer: the JAX package's export of the same weights
    has the same keys (weight norm split on the same layers), and the JAX
    loader reads the port's file to the arrays the port's loader gives."""
    port, _, params = synthesizers(vocoder=vocoder)
    cfg = port_get_config(32000, **SMALL_SYNTH_ARGS, model_vocoder=vocoder)
    PW.export_pth(port.state_dict(), cfg, str(tmp_path / "port.pth"))
    W.export_pth(params, get_config(32000, **SMALL_SYNTH_ARGS, model_vocoder=vocoder),
                 str(tmp_path / "jax.pth"))
    got_w = torch.load(tmp_path / "port.pth", weights_only=True)
    ref_w = torch.load(tmp_path / "jax.pth", weights_only=True)
    assert sorted(got_w["weight"]) == sorted(ref_w["weight"])
    assert got_w["vocoder"] == ref_w["vocoder"] == vocoder
    sd = W.load_torch_checkpoint(str(tmp_path / "port.pth"))
    sd.pop("__meta__")
    ref = PW.synthesizer_from_jax(W.convert_synthesizer_state_dict(sd))
    sd = PW.load_torch_checkpoint(str(tmp_path / "port.pth"))
    sd.pop("__meta__")
    got = PW.synthesizer_from_pth(sd)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy(), err_msg=k)


@pytest.mark.parametrize("vocoder", VOCODERS)
def test_jax_torch_state_dict_loads_strict(vocoder):
    """The JAX package's upstream state dict (weight norm split as
    parametrizations) -> `synthesizer_from_pth` -> strict load, within
    float32 of the weights it came from."""
    port, _, params = synthesizers(vocoder=vocoder)
    sd = PW.synthesizer_from_pth(W.synthesizer_params_to_torch_state_dict(params))
    model = build_synthesizer(port_get_config(32000, **SMALL_SYNTH_ARGS, model_vocoder=vocoder))
    model.load_state_dict(sd, strict=True)
    for k, v in port.state_dict().items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("kw", [dict(), dict(use_f0=False), dict(vocoder="MRF HiFi-GAN"),
                                dict(vocoder="RefineGAN")],
                         ids=["nsf", "f0less", "mrf", "refinegan"])
def test_synthesizer_to_jax_gives_the_jax_tree(kw):
    """The port's writer side: a port state dict -> the flat paths and
    layouts the JAX package's own converter gives, bit for bit; and back."""
    port, _, params = synthesizers(**kw)
    ref = W.flatten_tree(params)
    got = PW.synthesizer_to_jax(port.state_dict())
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    back = PW.synthesizer_from_jax(got)
    for k, v in port.state_dict().items():
        assert torch.equal(back[k], v), k
