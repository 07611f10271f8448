"""The port's pitch modules against the JAX package's, on the same numpy
inputs and weights: the host DSP copies (bit for bit), the STFT, CREPE,
FCPE, the RMVPE predictor, the `PitchExtractor` facade and the weight
carriers. Small widths; the weights go from the port to JAX through the
reference's own upstream converters."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rvc_tpu.models import crepe as JC
from rvc_tpu.models import fcpe as JF
from rvc_tpu.models.rmvpe import E2E as JaxE2E, RMVPE as JaxRMVPE
from rvc_tpu.pitch import PitchExtractor as JaxPitchExtractor
from rvc_tpu.pitch import autotune as JA, dsp as JD, world_dsp as JW
from rvc_tpu.utils import weights as JWT
from rvc_tpu_torch.models import crepe as PC
from rvc_tpu_torch.models import fcpe as PF
from rvc_tpu_torch.models.rmvpe import RMVPE
from rvc_tpu_torch.pitch import PitchExtractor
from rvc_tpu_torch.pitch import autotune as PA, dsp as PD, world_dsp as PW
from rvc_tpu_torch.utils import weights as W
from torch_port_helpers import SMALL_RMVPE, assert_parity, numpy_state, rmvpes

JS = importlib.import_module("rvc_tpu.ops.stft")       # the packages export `stft`, the function
PS = importlib.import_module("rvc_tpu_torch.ops.stft")
CLIPS = ["sine_wave", "chirp_wave", "voiced_unvoiced_wave"]


def _dio(mod, dsp, y):
    return dsp.stonemask_refine(y, mod.dio_f0(y, 16000, 160, 50.0, 1100.0), 16000, 160)


DSP = {
    "yin_f0": lambda w, d, y: d.yin_f0(y, 16000, 160, 50.0, 1100.0),
    "autocorr_f0": lambda w, d, y: d.autocorr_f0(y),
    "harvest_like_f0": lambda w, d, y: d.harvest_like_f0(y),
    "dio_f0+stonemask": lambda w, d, y: _dio(w, d, y),
    "harvest_f0": lambda w, d, y: w.harvest_f0(y, 16000, 160, 50.0, 1100.0),
}


@pytest.mark.parametrize("clip", CLIPS)
@pytest.mark.parametrize("fn", list(DSP))
def test_dsp_copies_are_bit_identical(request, fn, clip):
    y, _ = request.getfixturevalue(clip)
    got = DSP[fn](PW, PD, y)
    ref = DSP[fn](JW, JD, y)
    assert got.dtype == ref.dtype and (got > 0).any()
    np.testing.assert_array_equal(got, ref)


def test_autotune_copy(chirp_wave):
    f0 = np.asarray(JD.yin_f0(chirp_wave[0]))
    for strength in (0.0, 0.4, 1.0):
        np.testing.assert_array_equal(PA.autotune_f0(f0, strength), JA.autotune_f0(f0, strength))
    np.testing.assert_array_equal(PA.NOTE_TABLE, JA.NOTE_TABLE)
    np.testing.assert_array_equal(PA.Autotune().autotune_f0(f0), JA.Autotune().autotune_f0(f0))


@pytest.mark.parametrize("center,win", [(False, 1024), (True, 1024), (False, 800)])
def test_stft(center, win):
    y = np.random.default_rng(0).standard_normal((2, 5000)).astype(np.float32)
    got = PS.stft(torch.from_numpy(y), 1024, 160, win, center=center).numpy()
    ref = np.asarray(JS.stft(jnp.asarray(y), 1024, 160, win, center=center))
    assert got.shape == ref.shape and got.dtype == np.complex64
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=2e-4)


# --- CREPE ---------------------------------------------------------------


def _crepe_pair(variant: str, seed: int = 0):
    """(port CREPEModel, JAX params, JAX batch_stats) with random BN stats."""
    torch.manual_seed(seed)
    port = PC.CREPEModel(variant).eval()
    gen = torch.Generator().manual_seed(seed)
    for name, buf in port.named_buffers():
        if name.endswith("running_mean"):
            buf.copy_(0.1 * torch.randn(buf.shape, generator=gen))
        elif name.endswith("running_var"):
            buf.copy_(0.5 + torch.rand(buf.shape, generator=gen))
    params, stats = JWT.convert_crepe_state_dict(numpy_state(port))
    return port, params, stats


@pytest.mark.parametrize("variant,frames", [("tiny", 8), ("full", 3)])
def test_crepe_model(variant, frames):
    port, params, stats = _crepe_pair(variant)
    x = np.random.default_rng(1).standard_normal((frames, 1024)).astype(np.float32)
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    ref = np.asarray(JC.CREPEModel(variant).apply({"params": params, "batch_stats": stats},
                                                  jnp.asarray(x)))
    assert got.shape == ref.shape == (frames, 360)
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-4)


def test_frame_audio_is_population_normalized(chirp_wave):
    y = chirp_wave[0][None, :4000]
    got = PC.frame_audio(torch.from_numpy(y), 320).numpy()
    ref = np.asarray(JC.frame_audio(jnp.asarray(y), 320))
    assert got.shape == ref.shape == (1, 13, 1024)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("hop", [160, 320])
def test_crepe_get_f0(chirp_wave, hop):
    """f0 on the 10 ms grid: the same length, the same voicing, and within
    rtol 5e-3 on frames voiced on both sides."""
    port, params, stats = _crepe_pair("tiny", seed=3)
    y = chirp_wave[0]
    got, per = PC.CREPE(model=port).get_f0(y, hop=hop, return_periodicity=True)
    ref, ref_per = JC.CREPE("tiny", params=params, batch_stats=stats).get_f0(
        y, hop=hop, return_periodicity=True)
    assert got.shape == ref.shape == (101,) and got.dtype == np.float32
    both = (got > 0) & (ref > 0)
    assert both.mean() > 0.5 and ((got > 0) == (ref > 0)).mean() >= 0.98
    np.testing.assert_allclose(got[both], ref[both], rtol=5e-3)
    np.testing.assert_allclose(per, ref_per, rtol=1e-3, atol=1e-4)


def test_crepe_facade_builds_from_seed_on_the_host():
    a, b = PC.CREPE("tiny", device="cpu"), PC.CREPE("tiny", seed=0)
    assert a.device.type == "cpu" and not a.model.training
    for k, v in a.model.state_dict().items():
        torch.testing.assert_close(v, b.model.state_dict()[k], rtol=0, atol=0)


# --- FCPE ----------------------------------------------------------------


def _fcpe_pair(seed: int = 0):
    torch.manual_seed(seed)
    port = PF.FCPEModel(n_layers=2, n_chans=64,
                        generator=torch.Generator().manual_seed(seed)).eval()
    return port, JWT.convert_fcpe_state_dict(numpy_state(port))


def _jax_fcpe(params):
    ref = JF.FCPE(params=params)
    ref.model = JF.FCPEModel(n_layers=2, n_chans=64)   # read when its jit traces
    return ref


def test_fcpe_model():
    port, params = _fcpe_pair()
    mel = np.random.default_rng(2).standard_normal((1, 40, 128)).astype(np.float32)
    with torch.inference_mode():
        got = port(torch.from_numpy(mel)).numpy()
    ref = np.asarray(JF.FCPEModel(n_layers=2, n_chans=64).apply({"params": params},
                                                                jnp.asarray(mel)))
    assert got.shape == ref.shape == (1, 40, 360)
    assert_parity(got, ref, "FCPE salience")


def test_fcpe_mel(chirp_wave):
    """On a chirp with broadband noise, so every band holds more than the
    two FFTs' float32 round-off."""
    noise = 0.05 * np.random.default_rng(4).standard_normal(8000).astype(np.float32)
    y = (chirp_wave[0][:8000] + noise)[None]
    got = PF.FCPE(model=_fcpe_pair()[0]).mel(torch.from_numpy(y)).numpy()
    ref = np.asarray(_jax_fcpe({}).mel(jnp.asarray(y)))
    assert got.shape == ref.shape == (1, 50, 128)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_fcpe_infer_from_audio(voiced_unvoiced_wave):
    port, params = _fcpe_pair(seed=5)
    y = voiced_unvoiced_wave[0]
    got = PF.FCPE(model=port).infer_from_audio(y, threshold=0.03)
    ref = _jax_fcpe(params).infer_from_audio(y, threshold=0.03)
    assert got.shape == ref.shape == (100,)
    both = (got > 0) & (ref > 0)
    assert ((got > 0) == (ref > 0)).mean() >= 0.98 and both.any()
    np.testing.assert_allclose(got[both], ref[both], rtol=5e-3)


def _salience_cases():
    y = np.full((1, 6, 360), 0.01, np.float32)
    y[0, 0, 0] = 0.9                       # peak on the first bin: window clipped
    y[0, 1, 359] = 0.9                     # on the last bin
    y[0, 2, [100, 200]] = 0.7              # a tie: the first maximum wins
    y[0, 3, 180], y[0, 3, 179], y[0, 3, 183] = 0.8, 0.4, 0.3
    y[0, 4, 50] = 0.04                     # under the threshold: unvoiced
    y[0, 5, 3:6] = 0.6                     # a flat top near the low edge
    return y


def test_cents_local_decoder_ties_and_edges():
    y = _salience_cases()
    got = PF.cents_local_decoder(torch.from_numpy(y), 0.05).numpy()
    ref = np.asarray(JF.cents_local_decoder(jnp.asarray(y), 0.05))
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert got[0, 4] == 0 and (got[0, [0, 1, 2, 3, 5]] > 0).all()
    np.testing.assert_allclose(got[0, 2], 10 * 2 ** (PF.CENT_TABLE[100] / 1200), rtol=1e-5)


def test_crepe_decode_matches_at_the_edges():
    """CREPE zero-pads the window past the ends, where FCPE clips."""
    probs = _salience_cases()[0]
    got = [t.numpy() for t in PC.decode_probabilities(torch.from_numpy(probs), 30.0, 2000.0)]
    ref = [np.asarray(t) for t in JC.decode_probabilities(jnp.asarray(probs), 30.0, 2000.0)]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-6)


# --- RMVPE predictor -------------------------------------------------------


def _jax_rmvpe(variables):
    ref = JaxRMVPE(params=variables["params"], batch_stats=variables["batch_stats"])
    ref.model = JaxE2E(**SMALL_RMVPE)                 # read when its jit traces
    return ref


def test_rmvpe_predictor(chirp_wave):
    port, _, variables = rmvpes()
    y = chirp_wave[0]
    got = RMVPE(port).infer_from_audio(y)
    ref = _jax_rmvpe(variables).infer_from_audio(y)
    assert got.shape == ref.shape == (101,) and (got > 0).mean() > 0.5
    np.testing.assert_allclose(got, ref, rtol=1e-4)


# --- the facade -------------------------------------------------------------


def _facades(method):
    """(port PitchExtractor, JAX PitchExtractor) with the same small weights."""
    if method == "crepe-tiny":
        port, params, stats = _crepe_pair("tiny", seed=3)
        return (PitchExtractor(method, model=PC.CREPE(model=port)),
                JaxPitchExtractor(method, model=JC.CREPE("tiny", params=params,
                                                         batch_stats=stats)))
    if method == "fcpe":
        port, params = _fcpe_pair(seed=5)
        return PitchExtractor(method, model=PF.FCPE(model=port)), \
            JaxPitchExtractor(method, model=_jax_fcpe(params))
    if method == "rmvpe":
        port, _, variables = rmvpes()
        return PitchExtractor(method, rmvpe=RMVPE(port)), \
            JaxPitchExtractor(method, model=_jax_rmvpe(variables))
    return PitchExtractor(method), JaxPitchExtractor(method)


@pytest.mark.parametrize("method", ["pm", "dio", "harvest", "hybrid[pm+dio+harvest]",
                                    "crepe-tiny", "fcpe", "rmvpe"])
def test_extractor_methods(chirp_wave, method):
    """The DSP methods bit for bit; the neural ones on the same length and
    voicing, f0 within rtol 5e-3 (rmvpe 1e-4) on frames voiced on both."""
    port, ref_ext = _facades(method)
    y = chirp_wave[0]
    got, ref = port.extract(y, 50.0, 1100.0), ref_ext.extract(y, 50.0, 1100.0)
    assert got.dtype == np.float32 and got.shape == ref.shape and (got > 0).any()
    if port._model is None:
        np.testing.assert_array_equal(got, ref)
        return
    both = (got > 0) & (ref > 0)
    assert ((got > 0) == (ref > 0)).mean() >= 0.98
    np.testing.assert_allclose(got[both], ref[both], rtol=1e-4 if method == "rmvpe" else 5e-3)


def test_hybrid_of_neural_and_dsp(chirp_wave):
    """hybrid[rmvpe+crepe-tiny+pm]: its rmvpe component takes the RMVPE it
    is given; against the JAX facade over the same small components."""
    (port_rmvpe, ref_rmvpe), (port_crepe, ref_crepe) = _facades("rmvpe"), _facades("crepe-tiny")
    port = PitchExtractor("hybrid[rmvpe+crepe-tiny+pm]", device="cpu",
                          rmvpe=port_rmvpe._model)
    assert port._sub[0]._model is port_rmvpe._model
    assert isinstance(port._sub[1]._model, PC.CREPE) and port._sub[1]._model.variant == "tiny"
    port._sub[1] = port_crepe
    ref = JaxPitchExtractor("hybrid[pm+pm+pm]")       # components swapped in below
    ref._sub = [ref_rmvpe, ref_crepe, JaxPitchExtractor("pm")]
    y = chirp_wave[0]
    got, want = port.extract(y), ref.extract(y)
    assert got.shape == want.shape
    both = (got > 0) & (want > 0)
    assert ((got > 0) == (want > 0)).mean() >= 0.98 and both.any()
    np.testing.assert_allclose(got[both], want[both], rtol=5e-3)


class _Fixed:
    def __init__(self, f0):
        self.f0 = np.asarray(f0, np.float32)

    def extract(self, audio, lo, hi):
        return self.f0


@pytest.mark.parametrize("ests", [
    ([100.0, 0, 200, 50], [110.0, 0, 0, 60], [0.0, 0, 0, 70, 80]),
    ([300.0, 0, 0], [0.0, 0, 0], [150.0, 151, 0], [152.0, 0, 0]),
], ids=["three", "four"])
def test_hybrid_majority_voicing(ests):
    """Per frame, the median of the voiced estimates where at least half
    (rounded up) of the methods are voiced; cut to the shortest."""
    method = "hybrid[pm+dio+harvest]"
    port, ref = PitchExtractor(method), JaxPitchExtractor(method)
    port._sub = [_Fixed(e) for e in ests]
    ref._sub = [_Fixed(e) for e in ests]
    got, want = port.extract(np.zeros(480, np.float32)), ref.extract(np.zeros(480, np.float32))
    np.testing.assert_array_equal(got, want)
    if len(ests) == 3:
        np.testing.assert_allclose(got, [105.0, 0, 0, 60])


@pytest.mark.parametrize("method", ["hybrid[dio+nope]", "nope", "hybrid[]"])
def test_unknown_methods_raise(method):
    with pytest.raises(ValueError):
        PitchExtractor(method, device="cpu")
    with pytest.raises(ValueError):
        JaxPitchExtractor(method)


def test_neural_extractor_needs_a_device_or_cpu(monkeypatch):
    """A neural method built with no device runs on the card, and raises
    where there is none; DSP methods need no device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PitchExtractor("crepe-tiny")
    PitchExtractor("hybrid[pm+dio]").extract(np.zeros(1600, np.float32))


@pytest.mark.parametrize("method", ["crepe-tiny", "pm"])
def test_extract_with_confidence(chirp_wave, method):
    port, ref = _facades(method)
    y = chirp_wave[0]
    f0, conf = port.extract_with_confidence(y)
    f0_ref, conf_ref = ref.extract_with_confidence(y)
    assert f0.shape == conf.shape == conf_ref.shape
    np.testing.assert_allclose(conf, conf_ref, rtol=1e-3, atol=1e-4)
    if method == "pm":
        np.testing.assert_array_equal(conf, (f0 > 0).astype(np.float32))


# --- weights ------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["tiny", "full"])
def test_crepe_weights_round_trip(variant):
    port, params, stats = _crepe_pair(variant)
    back = W.crepe_from_jax(params, stats)
    model = PC.CREPEModel(variant)
    model.load_state_dict(back, strict=True)
    for k, v in port.state_dict().items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0)
    half = {k: v.half() if v.is_floating_point() else v for k, v in port.state_dict().items()}
    loaded = W.crepe_from_pth(half)
    assert all(v.dtype == torch.float32 for k, v in loaded.items()
               if not k.endswith("num_batches_tracked"))
    model.load_state_dict(loaded, strict=True)
    torch.testing.assert_close(model.conv2.weight, port.conv2.weight.half().float(),
                               rtol=0, atol=0)


@pytest.mark.parametrize("naming", ["weight_g", "parametrizations"])
def test_fcpe_weights_round_trip(naming):
    port, params = _fcpe_pair()
    model = PF.FCPEModel(n_layers=2, n_chans=64)
    model.load_state_dict(W.fcpe_from_jax(params), strict=True)
    for k, v in port.state_dict().items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0)
    # an upstream fcpe.pt "model": dense_out under weight norm, and buffers
    # the port does not keep
    sd = numpy_state(port)
    w = sd.pop("dense_out.weight")
    g = 2.0 * np.linalg.norm(w, axis=1, keepdims=True)
    if naming == "weight_g":
        sd["dense_out.weight_g"], sd["dense_out.weight_v"] = g, 2.0 * w
    else:
        sd["dense_out.parametrizations.weight.original0"] = g
        sd["dense_out.parametrizations.weight.original1"] = 2.0 * w
    sd["cent_table"] = np.zeros(360, np.float32)
    sd["gaussian_blurred_cent_mask"] = np.zeros(360, np.float32)
    model.load_state_dict(W.fcpe_from_pth(sd), strict=True)
    torch.testing.assert_close(model.dense_out.weight, torch.from_numpy(2.0 * w), rtol=1e-6,
                               atol=1e-7)
    ref = W.fcpe_from_jax(JWT.convert_fcpe_state_dict(sd))
    for k, v in W.fcpe_from_pth(sd).items():
        torch.testing.assert_close(v, ref[k], rtol=0, atol=0)
