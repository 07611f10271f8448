"""The rest of `infer` on the host: the port's copies of split / merge,
`reduce_noise`, `formant_shift`, the ten effects and `build_fx_chain`, and
`encode_audio`, against the JAX package's on the same seeded numpy input
(equal bit for bit); then `RVC.infer` with every flag on against the JAX
`RVC.infer` over the small model pairs (same length, waveform corr >
0.995)."""

import shutil
import sys

import numpy as np
import pytest

from rvc_tpu import api as jax_api
from rvc_tpu.configs import get_config
from rvc_tpu.pipelines.offline import Pipeline as JaxPipeline
from rvc_tpu.pitch import PitchExtractor as JaxPitchExtractor
from rvc_tpu.realtime import fx as JFX
from rvc_tpu.utils import audio as JA
from rvc_tpu.utils import formant as JFO
from rvc_tpu.utils import noise as JN
from rvc_tpu.utils import split_audio as JS
from rvc_tpu_torch import api as port_api
from rvc_tpu_torch.configs import get_config as port_get_config
from rvc_tpu_torch.pipelines.offline import Pipeline
from rvc_tpu_torch.realtime import fx as PFX
from rvc_tpu_torch.utils import audio as PA
from rvc_tpu_torch.utils import formant as PFO
from rvc_tpu_torch.utils import noise as PN
from rvc_tpu_torch.utils import split_audio as PS
from torch_port_helpers import SMALL_SYNTH_ARGS, huberts, rmvpes, synthesizers

SR = 32000


def _tone(seconds, f, seed, sr=16000):
    t = np.arange(int(seconds * sr)) / sr
    noise = 0.02 * np.random.default_rng(seed).standard_normal(len(t))
    return (0.4 * np.sin(2 * np.pi * (f * t + 30 * t * t)) + noise).astype(np.float32)


def _gapped(sr=16000):
    """Voice, 0.6 s of near silence, a 0.25 s burst, 0.6 s, voice: three
    non-silent intervals, the middle one shorter than the pipeline's
    1 s x_pad once split."""
    quiet = lambda s: (1e-4 * np.random.default_rng(9).standard_normal(int(s * sr))
                       ).astype(np.float32)
    return np.concatenate([_tone(0.5, 140, 1, sr), quiet(0.6), _tone(0.25, 220, 2, sr),
                           quiet(0.6), _tone(0.7, 180, 3, sr)])


def test_split_and_merge_equal_jax():
    audio = _gapped()
    intervals, segs = PS.split_silence_nonsilent(audio, 16000)
    ref_intervals, ref_segs = JS.split_silence_nonsilent(audio, 16000)
    assert intervals == ref_intervals and len(intervals) == 3
    for s, r in zip(segs, ref_segs):
        assert np.array_equal(s, r)
    converted = [np.repeat(s, 2) * 0.5 for s in segs]
    got = PS.merge_audio(intervals, converted, len(audio), 16000, 32000)
    ref = JS.merge_audio(ref_intervals, converted, len(audio), 16000, 32000)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    silent = np.zeros(3000, np.float32)
    assert PS.split_silence_nonsilent(silent, 16000)[0] == [(0, 3000)]


@pytest.mark.parametrize("strength,n", [(0.5, 24000), (1.0, 24000), (0.7, 800)],
                         ids=["half", "full", "shorter-than-fft"])
def test_reduce_noise_equals_jax(strength, n):
    audio = _tone(n / 32000, 200, 4, sr=32000)
    got, ref = PN.reduce_noise(audio, 32000, strength), JN.reduce_noise(audio, 32000, strength)
    assert got.dtype == ref.dtype == np.float32 and np.array_equal(got, ref)


@pytest.mark.parametrize("quefrency,timbre", [(1.0, 1.2), (0.5, 0.8), (1.0, 1.0)])
def test_formant_shift_equals_jax(quefrency, timbre):
    audio = _tone(0.7, 150, 5)
    got = PFO.formant_shift(audio, 16000, quefrency, timbre)
    ref = JFO.formant_shift(audio, 16000, quefrency, timbre)
    assert got.dtype == ref.dtype == np.float32 and np.array_equal(got, ref)


EFFECTS = {
    "gain": ("gain_fx", (3.0,)),
    "distortion": ("distortion_fx", (25.0,)),
    "clipping": ("clipping_fx", (-6.0,)),
    "bitcrush": ("bitcrush_fx", (6,)),
    "limiter": ("limiter_fx", (-12.0, 30.0)),
    "compressor": ("compressor_fx", (-20.0, 4.0, 1.0, 100.0)),
    "delay": ("delay_fx", (0.05, 0.5, 0.4)),
    "chorus": ("chorus_fx", (1.5, 0.3, 7.0, 0.0, 0.5)),
    "pitch_shift": ("pitch_shift_fx", (3.0,)),
    "reverb": ("reverb_fx", (0.7, 0.3, 0.4, 0.5, 1.0, 0.0)),
}


@pytest.mark.parametrize("name", list(EFFECTS))
def test_effect_equals_jax(name):
    fn, args = EFFECTS[name]
    x = _tone(0.25, 180, 6, sr=32000)
    got = getattr(PFX, fn)(*args)(x, 32000)
    ref = getattr(JFX, fn)(*args)(x, 32000)
    assert np.asarray(got).dtype == np.asarray(ref).dtype and np.array_equal(got, ref)


FX_ALL = dict(reverb=True, pitch_shift=True, limiter=True, gain=True, distortion=True,
              chorus=True, bitcrush=True, clipping=True, compressor=True, delay=True,
              pitch_shift_semitones=2.0, reverb_room_size=0.6, limiter_threshold=-8.0,
              gain_db=3.0, distortion_gain=12.0, chorus_rate=1.2, bitcrush_bit_depth=12.0,
              clipping_threshold=-1.0, compressor_threshold=-18.0, compressor_ratio=3.0,
              delay_seconds=0.05, delay_feedback=0.3, delay_mix=0.3)


@pytest.mark.parametrize("flags", [FX_ALL, dict(reverb=True, gain=True, gain_db=-2.0), {}],
                         ids=["all-ten", "two", "none"])
def test_fx_chain_equals_jax(flags):
    x = _tone(0.3, 160, 7, sr=32000)
    chain, ref_chain = PFX.build_fx_chain(**flags), JFX.build_fx_chain(**flags)
    assert len(chain.effects) == len(ref_chain.effects) == sum(
        1 for k, v in flags.items() if v is True)
    assert [e.__qualname__.split(".")[0] for e in chain.effects] == \
        [e.__qualname__.split(".")[0] for e in ref_chain.effects]
    got, ref = chain(x, 32000), ref_chain(x, 32000)
    assert got.dtype == ref.dtype == np.float32 and np.array_equal(got, ref)


def _no_encoder(monkeypatch):
    monkeypatch.setitem(sys.modules, "soundfile", None)    # import raises ImportError
    monkeypatch.setattr(shutil, "which", lambda name: None)


@pytest.mark.parametrize("fmt", ["MP3", "FLAC"])
def test_encode_audio_without_an_encoder_raises_as_jax(fmt, tmp_path, monkeypatch):
    _no_encoder(monkeypatch)
    audio = _tone(0.1, 200, 8, sr=32000)
    errors = []
    for encode in (PA.encode_audio, JA.encode_audio):
        with pytest.raises(RuntimeError, match=f"cannot export {fmt}") as info:
            encode(audio, 32000, str(tmp_path / "out"), fmt)
        errors.append(str(info.value))
    assert errors[0] == errors[1]
    assert list(tmp_path.iterdir()) == []


@pytest.fixture(scope="module")
def rvcs():
    """(JAX RVC, port RVC) around the small model pairs (RVC's own
    constructors build full-size HuBERT and RMVPE), no index, noise off."""
    from types import SimpleNamespace

    import torch

    port_s, jax_s, s_params = synthesizers()
    port_h, jax_h, h_params = huberts()
    port_r, jax_r, r_vars = rmvpes()
    ref = object.__new__(jax_api.RVC)
    ref.cfg, ref.index = get_config(32000, **SMALL_SYNTH_ARGS), None
    ref.pipeline = JaxPipeline(
        tgt_sr=SR, synthesizer=jax_s, synth_variables={"params": s_params}, hubert=jax_h,
        hubert_variables={"params": h_params},
        pitch_extractor=JaxPitchExtractor("rmvpe",
                                          model=SimpleNamespace(model=jax_r, variables=r_vars)))
    port = object.__new__(port_api.RVC)
    port.cfg, port.index = port_get_config(32000, **SMALL_SYNTH_ARGS), None
    port.device = torch.device("cpu")
    port.pipeline = Pipeline(SR, port_s, port_h, port_r)
    return ref, port


def test_infer_with_every_flag_matches_jax(rvcs, monkeypatch):
    """Formant shift on the input, three split segments (one shorter than
    x_pad), noise reduction and all ten effects: the same length, waveform
    corr > 0.995."""
    monkeypatch.setenv("RVC_TPU_SOURCE_NOISE", "0")
    monkeypatch.setenv("RVC_TPU_F16_IN", "0")
    monkeypatch.setenv("RVC_TPU_F16_OUT", "0")
    ref_rvc, port_rvc = rvcs
    audio = _gapped()
    kw = dict(sid=1, pitch=1.0, split_audio=True, clean_audio=True, clean_strength=0.7,
              formant_shifting=True, formant_qfrency=1.0, formant_timbre=1.2,
              post_process=True, **FX_ALL)
    ref = ref_rvc.infer(audio, **kw)
    got = port_rvc.infer(audio, **kw)
    assert got.dtype == np.float32 and got.shape == ref.shape == (len(audio) * 2 + 1,)
    corr = np.corrcoef(got, ref)[0, 1]
    assert corr > 0.995, f"waveform corr {corr:.6f}"
    plain = port_rvc.infer(audio, sid=1, pitch=1.0)
    assert plain.shape == (len(audio) * 2,) and np.corrcoef(got[:-1], plain)[0, 1] < 0.99


def test_infer_file_exports_through_encode_audio(rvcs, tmp_path, monkeypatch):
    """A non-WAV export without soundfile or ffmpeg raises the encoder's
    RuntimeError and writes nothing; WAV writes the file asked for."""
    _no_encoder(monkeypatch)
    _, port_rvc = rvcs
    PA.save_wav(str(tmp_path / "in.wav"), _tone(0.4, 150, 10), 16000)
    with pytest.raises(RuntimeError, match="cannot export OGG"):
        port_rvc.infer_file(str(tmp_path / "in.wav"), str(tmp_path / "out.wav"),
                            export_format="OGG")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["in.wav"]
    assert port_rvc.infer_file(str(tmp_path / "in.wav"), str(tmp_path / "out.wav"),
                               export_format="wav") == str(tmp_path / "out.wav")
