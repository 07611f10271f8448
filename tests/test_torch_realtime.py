"""The port's realtime engine (`rvc_tpu_torch.realtime`) against the JAX
package's (`rvc_tpu.realtime`) on the CPU, on the same small models and the
same audio: the host copies (circular write, VAD) equal bit for bit; the
SOLA step against the reference's (its offsets against the JAX package's
native `sola_align`); the fused block program on the same buffer and pitch state;
`Realtime.inference` over 4 blocks on the fused path (plain, pitch shift
with autotune, retrieval) and the staged path (pm); the silence
short-circuit and the zero roll it owes the pitch state; and
`VoiceChanger.on_request`'s SOLA streaming.

Both sides run with source noise off (`RVC_TPU_SOURCE_NOISE=0`, which the
port's pipeline reads at each call: torch cannot draw JAX's bits). The JAX
block program uploads its audio and returns its block in float16
(`rvc_tpu/realtime/core.py:117, 300`); the port stays float32. Bars:
- block program, on a float16-exact buffer (so that the JAX upload is
  lossless): the same shape, waveform corr > 0.995, atol 5e-3 (the JAX
  tests' bar for its fused block against its staged one), the new pitch
  state within 1e-3 Hz on frames voiced on both sides and voiced on the
  same frames; float32 (RVC_TPU_BF16=0, the CPU's default), and in its
  bf16 case under RVC_TPU_BF16=1 on both sides;
- `Realtime` and `VoiceChanger` blocks: the same length, corr > 0.995,
  atol 5e-3. The fused pitch state within 5e-3 Hz: there the JAX upload
  rounds the buffer to float16 (relative 2^-11), which moves the decoded
  f0 by up to 1.25e-3 Hz at 150-200 Hz (measured); the staged pitch
  buffers (host pm) equal bit for bit; SOLA offsets equal.

The models are built with the decoder's upsampling weights scaled by
`UPS_GAIN`, so that the waveform follows the content path (HuBERT, the
encoder, the flow, the protect blend, the speaker embedding) and not the
sine source alone.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_tpu import native as jax_native
from rvc_tpu import retrieval as JR
from rvc_tpu.pipelines.offline import Pipeline as JaxPipeline
from rvc_tpu.pipelines.offline import autotune_f0_jnp
from rvc_tpu.pitch import PitchExtractor
from rvc_tpu.realtime import core as JC
from rvc_tpu.realtime.buffer import circular_write as jax_circular_write
from rvc_tpu.realtime.pool import VoiceChangerPool as JaxPool
from rvc_tpu.realtime.vad import VADProcessor as JaxVAD
from rvc_tpu_torch import retrieval as PR
from rvc_tpu_torch.configs import get_config as port_get_config
from rvc_tpu_torch.pipelines.offline import Pipeline, autotune_f0_torch
from rvc_tpu_torch.realtime import core as PC
from rvc_tpu_torch.realtime.buffer import circular_write
from rvc_tpu_torch.realtime.pool import VoiceChangerPool
from rvc_tpu_torch.realtime.vad import VADProcessor
from torch_port_helpers import SMALL_SYNTH_ARGS, huberts, rmvpes, synthesizers

SR = 32000
BLOCK = 48 * 128          # read_chunk_size 48: 6,144 samples at 48 kHz
SESSION = dict(read_chunk_size=48, cross_fade_overlap_size=0.05, extra_convert_size=0.2)
GEOM48 = (BLOCK, int(0.2 * 48000), int(0.05 * 48000), 48000 // 100)
UPS_GAIN = 20.0           # see torch_port_helpers.synthesizers


@pytest.fixture(scope="module", autouse=True)
def two_threads_no_noise():
    """Torch on two threads beside the suite's other workers; the JAX
    programs traced without source noise (they read it when built), and
    the JAX engine on its fused route, which it reads from RVC_TPU_RT_FUSED
    (the port's engine has no such switch)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RVC_TPU_SOURCE_NOISE", "0")
        mp.setenv("RVC_TPU_RT_FUSED", "1")
        yield
    torch.set_num_threads(n)


def _clip48(n_blocks: int, seed: int = 0, f_start: float = 150.0) -> np.ndarray:
    """A voiced 48 kHz sweep (f_start -> +50 Hz/s) with a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_blocks * BLOCK) / 48000
    phase = 2 * np.pi * np.cumsum(f_start + 50 * t) / 48000
    return (0.4 * np.sin(phase) + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


def _index_pair():
    """(JAX index, port index) of the same arrays: IVFFlat over the small
    HuBERT's features of six chirps near the test audio's pitch."""
    port_h = huberts()[0]
    with torch.inference_mode():
        feats = []
        for s in range(1, 7):
            t = np.arange(16000) / 16000
            clip = 0.4 * np.sin(2 * np.pi * ((140 + 10 * s) * t + 25 * t * t))
            feats.append(port_h(torch.from_numpy(clip.astype(np.float32))[None])[0].numpy())
    ref = JR.build_index(np.concatenate(feats), seed=0)
    return ref, PR.IVFFlatIndex(centroids=ref.centroids.copy(), vectors=ref.vectors.copy(),
                                list_ids=ref.list_ids.copy(), nprobe=ref.nprobe)


def make_pair(ups_gain: float = UPS_GAIN, index: bool = False) -> SimpleNamespace:
    """The JAX and port `rvc` stand-ins (pipeline, cfg, index) over the same
    small models, and a JAX `Realtime` whose compiled block programs the
    other JAX engines of the pair share (`share`)."""
    port_s, jax_s, s_params = synthesizers(ups_gain=ups_gain)
    port_h, jax_h, h_params = huberts()
    port_r, jax_r, r_vars = rmvpes()
    pitch = PitchExtractor("rmvpe", model=SimpleNamespace(model=jax_r, variables=r_vars))
    ref_pipe = JaxPipeline(tgt_sr=SR, synthesizer=jax_s, synth_variables={"params": s_params},
                           hubert=jax_h, hubert_variables={"params": h_params},
                           pitch_extractor=pitch)
    jidx, pidx = _index_pair() if index else (None, None)
    jax_rvc = SimpleNamespace(pipeline=ref_pipe, cfg=SimpleNamespace(
        data=SimpleNamespace(sample_rate=SR)), index=jidx)
    port_rvc = SimpleNamespace(pipeline=Pipeline(SR, port_s, port_h, port_r),
                               cfg=port_get_config(SR, **SMALL_SYNTH_ARGS), index=pidx)
    proto = JC.Realtime(jax_rvc)
    proto.realloc(*GEOM48)

    def share(rt):
        """Give a JAX Realtime of this pair, realloc'ed at GEOM48, the
        pair's compiled programs."""
        proto._get_block_program(False)
        rt._block_fns, rt._block_pad = proto._block_fns, proto._block_pad
        rt._pitchf_dev = jnp.zeros((1, rt.convert_feature_size), jnp.float32)
        return rt

    return SimpleNamespace(jax=jax_rvc, port=port_rvc, proto=proto, share=share)


@pytest.fixture(scope="module")
def pair():
    return make_pair()


@pytest.fixture(scope="module")
def index_pair():
    return make_pair(index=True)


def _realtimes(p, **kw):
    jrt = JC.Realtime(p.jax, silent_threshold=-90, **kw)
    prt = PC.Realtime(p.port, silent_threshold=-90, **kw)
    for rt in (jrt, prt):
        rt.realloc(*GEOM48)
    return p.share(jrt), prt


def _assert_block(got, ref, what):
    assert got.shape == ref.shape, what
    assert np.isfinite(got).all(), what
    corr = np.corrcoef(got.ravel(), ref.ravel())[0, 1]
    assert corr > 0.995, f"{what}: waveform corr {corr:.6f}"
    np.testing.assert_allclose(got, ref, atol=5e-3, err_msg=what)


def _assert_pitch(got, ref, atol, what):
    """Voiced on the same frames, and within atol Hz on them."""
    np.testing.assert_array_equal(got > 0, ref > 0, err_msg=f"{what}: voicing")
    v = ref > 0
    assert v.any(), f"{what}: nothing voiced"
    np.testing.assert_allclose(got[v], ref[v], rtol=0, atol=atol, err_msg=what)


# ----------------------------------------------------------------------------
# host copies


@pytest.mark.parametrize("n", [3, 100, 250, 1000], ids=lambda n: f"write{n}")
def test_circular_write_equals_jax(n):
    """Writes shorter than, equal to and longer than the 250-sample buffer,
    in sequence, bit for bit."""
    rng = np.random.default_rng(n)
    got, ref = np.zeros(250, np.float32), np.zeros(250, np.float32)
    for _ in range(3):
        data = rng.standard_normal(n).astype(np.float32)
        assert circular_write(data, got) is got
        jax_circular_write(data, ref)
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("sensitivity", [0, 3])
def test_vad_equals_jax(sensitivity):
    """The energy gate's decisions and its adaptive noise floor, block by
    block over silence, noise, speech and a fade, bit for bit."""
    rng = np.random.default_rng(sensitivity)
    t = np.arange(480) / 16000
    blocks = ([np.zeros(480, np.float32) + 1e-5] * 4
              + [(a * rng.standard_normal(480)).astype(np.float32) for a in (1e-4, 3e-4, 1e-3)]
              + [(a * np.sin(2 * np.pi * 220 * t)).astype(np.float32) for a in (0.5, 0.05, 1e-3)])
    got, ref = VADProcessor(sensitivity), JaxVAD(sensitivity)
    assert got._vad is None and ref._vad is None      # no webrtcvad here
    for b in blocks:
        assert got.is_speech(b) == ref.is_speech(b)
        assert got._noise_rms == ref._noise_rms


def test_autotune_strength_zero_is_identity():
    """The JAX block program autotunes at strength 0 every block; the
    port's f0 program skips autotune at 0. Both are the identity, bit for
    bit, on a voiced contour with unvoiced frames."""
    rng = np.random.default_rng(5)
    f0 = (rng.uniform(60, 900, 400) * (rng.uniform(size=400) > 0.2)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(autotune_f0_jnp(jnp.asarray(f0), 0.0)), f0)
    np.testing.assert_array_equal(autotune_f0_torch(torch.from_numpy(f0), 0.0).numpy(), f0)


# ----------------------------------------------------------------------------
# the block program


@pytest.mark.parametrize("case", ["plain", "index", "bf16"])
def test_block_program_matches_jax(pair, index_pair, monkeypatch, case):
    """The same float16-exact buffer and pitch state through both block
    programs, with sid 1, protect 0.33, +2 semitones (and index_rate 0.7).
    bf16: a pair made under RVC_TPU_BF16=1 (the JAX pipeline packs and
    traces under it; the port reads it at each block)."""
    use_index = case == "index"
    p = index_pair if use_index else pair
    if case == "bf16":
        monkeypatch.setenv("RVC_TPU_BF16", "1")
        p = make_pair()
    proto = p.proto
    jfn = proto._get_block_program(use_index)
    geom = dict(sf=proto.silence_front_frames, bf=proto.block_16k // 160,
                F=proto.convert_feature_size, skip=proto.skip_head, ret=proto.return_length,
                spf=SR // 100, win=160, L=len(proto.convert_buffer))
    pfn = PC.build_block_program(p.port.pipeline, use_index=use_index, **geom)

    rng = np.random.default_rng(7)
    a16 = np.repeat(_clip48(1, seed=3)[::3][None], 2, axis=0).ravel()
    buf = np.resize(a16, geom["L"] + proto._block_pad).astype(np.float16).astype(np.float32)
    n = geom["F"]
    state = (rng.uniform(100, 300, n) * (rng.uniform(size=n) > 0.3)).astype(np.float32)[None]
    pipe = p.jax.pipeline
    sb, hb, rb = pipe._packed["bufs"]
    jargs = (rb, sb, hb, jnp.asarray(buf[None].astype(np.float16)), jnp.asarray(state),
             jnp.asarray([1], jnp.int32), jnp.float32(0.33), jnp.float32(2.0), jnp.float32(0.0))
    if use_index:
        ref_block, ref_state = jfn(*jargs, jnp.float32(0.7), p.jax.index._dev(),
                                   nprobe=p.jax.index.nprobe)
    else:
        ref_block, ref_state = jfn(*jargs)
    block, new_state = pfn(torch.from_numpy(buf[None]), torch.from_numpy(state),
                           torch.tensor([1]), 0.33, 2.0, 0.0,
                           index=p.port.index, index_rate=0.7)
    assert block.shape == (1, geom["ret"] * geom["spf"])
    _assert_block(block.numpy(), np.asarray(ref_block).astype(np.float32), "block")
    # the first sf frames are the old state rolled left by one block
    np.testing.assert_array_equal(new_state[0, :geom["sf"]].numpy(),
                                  state[0, geom["bf"]: geom["bf"] + geom["sf"]])
    _assert_pitch(new_state.numpy(), np.asarray(ref_state), 1e-3, "pitch state")
    assert (p.port.pipeline._bf16 is not None) == (case == "bf16")


# ----------------------------------------------------------------------------
# Realtime over 4 blocks


SCENARIOS = {
    "fused": dict(),
    "shift+autotune": dict(f0_up_key=2.0, f0_autotune=True, f0_autotune_strength=0.5,
                           protect=0.33),
    "index": dict(index_rate=0.7),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_realtime_fused_matches_jax(pair, index_pair, name):
    kw = {"index_rate": 0.0, **SCENARIOS[name]}
    p = index_pair if name == "index" else pair
    jrt, prt = _realtimes(p)
    clip = _clip48(4, seed=1)
    for i in range(4):
        b = clip[i * BLOCK: (i + 1) * BLOCK]
        ref, ref_vol = jrt.inference(b, **kw)
        got, vol = prt.inference(b, **kw)
        assert vol == pytest.approx(ref_vol, rel=1e-6)
        assert got.shape == (prt.return_length * 480,)
        _assert_block(got, ref, f"{name} block {i}")
        _assert_pitch(prt._pitchf_dev[0].numpy(), np.asarray(jrt._pitchf_dev)[0], 5e-3,
                      f"{name} block {i} pitch state")


def test_realtime_staged_pm_matches_jax():
    """f0_method pm takes the staged path on both sides: host pitch buffers
    equal bit for bit, the blocks within the bars."""
    p = make_pair()
    jrt, prt = _realtimes(p, f0_method="pm")
    clip = _clip48(4, seed=2)
    for i in range(4):
        b = clip[i * BLOCK: (i + 1) * BLOCK]
        ref, _ = jrt.inference(b, f0_up_key=-3.0, index_rate=0.0, protect=0.33)
        got, _ = prt.inference(b, f0_up_key=-3.0, index_rate=0.0, protect=0.33)
        np.testing.assert_array_equal(prt.pitchf_buffer, jrt.pitchf_buffer)
        np.testing.assert_array_equal(prt.pitch_buffer, jrt.pitch_buffer)
        _assert_block(got, ref, f"staged pm block {i}")
    assert prt._pitchf_dev is None      # the fused program never ran


# ----------------------------------------------------------------------------
# silence


@pytest.mark.parametrize("owed", ["1", "F-1", "F", "F+5"])
def test_pending_zero_roll(pair, owed):
    """The roll owed by silent blocks, on the device state: left by p
    frames with zeros behind, all zeros from F on (the JAX formula)."""
    _, prt = _realtimes(pair)
    prt._get_block_program(False)
    n = prt.convert_feature_size
    p = {"1": 1, "F-1": n - 1, "F": n, "F+5": n + 5}[owed]
    state = np.random.default_rng(p).uniform(50, 400, (1, n)).astype(np.float32)
    prt._pitchf_dev = torch.from_numpy(state)
    prt._pending_zero_frames = p
    prt._apply_pending_roll()
    want = (np.zeros_like(state) if p >= n
            else np.concatenate([state[:, p:], np.zeros((1, p), np.float32)], axis=1))
    np.testing.assert_array_equal(prt._pitchf_dev.numpy(), want)
    assert prt._pending_zero_frames == 0


def test_silence_short_circuit_matches_jax(pair, monkeypatch):
    """Speech, a transition block, five silent blocks, speech again: a
    silent block returns zeros and dispatches nothing (no block program,
    no staged f0, no conversion, no kernel wrapper), the owed frames
    saturate at F, and the blocks after the silence match JAX's."""
    from rvc_tpu_torch.ops.kernels import LAUNCHES

    jrt, prt = _realtimes(pair)
    jrt.input_sensitivity = prt.input_sensitivity = 10 ** (-40 / 20)
    clip = _clip48(3, seed=4)
    silence = np.zeros(BLOCK, np.float32)
    for rt in (jrt, prt):
        rt.inference(clip[:BLOCK], index_rate=0.0)
        rt.inference(silence, index_rate=0.0)      # the volume buffer still holds speech
        assert rt._pending_zero_frames == 0

    def boom(*a, **k):
        raise AssertionError("device dispatch on a gated block")

    for rt in (jrt, prt):
        monkeypatch.setattr(rt, "_get_block_program", boom)
        monkeypatch.setattr(rt, "_update_pitch", boom)
        monkeypatch.setattr(rt.rvc.pipeline, "voice_conversion", boom)
    monkeypatch.setattr(prt.rvc.pipeline, "f0", boom)
    monkeypatch.setattr(prt.rvc.pipeline, "hubert", boom)
    launches = dict(LAUNCHES)
    bf, n = prt.block_16k // 160, prt.convert_feature_size
    for i in range(5):
        got, vol = prt.inference(silence, index_rate=0.0)
        ref, ref_vol = jrt.inference(silence, index_rate=0.0)
        assert got.shape == ref.shape and not got.any()
        assert vol == ref_vol == 0.0
        assert prt._pending_zero_frames == jrt._pending_zero_frames == min((i + 1) * bf, n)
        np.testing.assert_array_equal(prt.pitchf_buffer, jrt.pitchf_buffer)
    assert dict(LAUNCHES) == launches
    monkeypatch.undo()
    monkeypatch.setenv("RVC_TPU_SOURCE_NOISE", "0")

    for i in (1, 2):
        b = clip[i * BLOCK: (i + 1) * BLOCK]
        ref, _ = jrt.inference(b, index_rate=0.0)
        got, _ = prt.inference(b, index_rate=0.0)
        assert prt._pending_zero_frames == jrt._pending_zero_frames == 0
        _assert_block(got, ref, f"after silence, block {i}")
        _assert_pitch(prt._pitchf_dev[0].numpy(), np.asarray(jrt._pitchf_dev)[0], 5e-3,
                      f"after silence, block {i} pitch state")


# ----------------------------------------------------------------------------
# VoiceChanger


def test_voice_changer_streams_match_jax(pair, monkeypatch):
    """on_request over 5 blocks: each output block_frame long, its timings
    [0, ms, 0], within the bars of JAX's, with equal SOLA offsets."""
    offsets = {"port": [], "jax": []}

    def recorder(fn, key):
        def rec(*a, **k):
            off = fn(*a, **k)
            offsets[key].append(off)
            return off
        return rec

    monkeypatch.setattr(PC, "sola_offset_scipy", recorder(PC.sola_offset_scipy, "port"))
    monkeypatch.setattr(jax_native, "sola_align", recorder(jax_native.sola_align, "jax"))
    jvc = JC.VoiceChanger(pair.jax, silent_threshold=-90, **SESSION)
    pair.share(jvc.vc_model)
    pvc = PC.VoiceChanger(pair.port, silent_threshold=-90, **SESSION)
    assert pvc.block_frame == BLOCK
    clip = _clip48(5, seed=6, f_start=180.0)
    for i in range(5):
        b = clip[i * BLOCK: (i + 1) * BLOCK]
        ref, ref_vol, _ = jvc.on_request(b, index_rate=0.0)
        got, vol, timings = pvc.on_request(b, index_rate=0.0)
        assert got.shape == (BLOCK,) and timings[0] == timings[2] == 0 and timings[1] > 0
        _assert_block(got, ref, f"on_request block {i}")
    assert offsets["port"] == offsets["jax"] and len(offsets["port"]) == 5


# ----------------------------------------------------------------------------
# SOLA


@pytest.mark.parametrize("seed", range(4))
def test_sola_offset_matches_jax_native(seed):
    """At VoiceChanger's geometry (len(x) = crossfade + search, where the
    native search and scipy's valid positions are the same 481), the scipy
    offset equals the JAX package's native one (the reference's SOLA where
    its library builds); seed 0 plants the reference 37 samples in."""
    rng = np.random.default_rng(seed)
    cross, search = 2400, 480
    ref = rng.standard_normal(cross).astype(np.float32)
    shift = 37 if seed == 0 else int(rng.integers(0, search + 1))
    x = 0.1 * rng.standard_normal(cross + search).astype(np.float32)
    x[shift: shift + cross] += ref
    got = PC.sola_offset_scipy(x, ref)
    assert got == shift
    if jax_native.available():
        assert got == jax_native.sola_align(x, ref, search)


@pytest.mark.parametrize("length", [1000, 3000, 9000], ids=["short", "mid", "long"])
@pytest.mark.parametrize("engine", ["voice_changer", "pool"])
def test_sola_step_matches_reference(engine, length, monkeypatch):
    """`sola_crossfade`, through VoiceChanger.process_audio and the pool's
    process, against the JAX engines' own SOLA code on the same converted
    audio, over three calls (the tail carried in sola_buffer), bit for
    bit: audio shorter than crossfade + search, shorter than block +
    crossfade, and longer; the pool's gated stream zeroed."""
    block, cross, search = BLOCK // 2, 2400, 480
    rng = np.random.default_rng(length)
    fade = np.sin(0.5 * np.pi * np.linspace(0, 1, cross, dtype=np.float32)) ** 2
    n = 1 if engine == "voice_changer" else 2
    sides = []
    for cls in ((JC.VoiceChanger, PC.VoiceChanger) if n == 1
                else (JaxPool, VoiceChangerPool)):
        e = object.__new__(cls)
        e.crossfade_frame, e.sola_search_frame, e.block_frame = cross, search, block
        e.fade_in, e.fade_out = fade, 1.0 - fade
        e.sola_buffer = np.zeros((n, cross) if n > 1 else cross, np.float32)
        e.n, e.input_sensitivity = n, 0.1
        sides.append(e)
    for i in range(3):
        audio = (0.5 * rng.standard_normal((n, length))).astype(np.float32)
        outs = []
        for e in sides:
            if n == 1:
                e.vc_model = SimpleNamespace(inference=lambda a, **k: (audio[0].copy(), 0.5))
                outs.append(e.process_audio(np.zeros(block, np.float32))[0])
            else:
                e._vols = np.array([0.5, 0.05])
                monkeypatch.setattr(e, "_convert", lambda *a: audio.copy(), raising=False)
                outs.append(e.process(np.zeros((n, block), np.float32))[0])
        np.testing.assert_array_equal(outs[1], outs[0], err_msg=f"call {i}")
        np.testing.assert_array_equal(sides[1].sola_buffer, sides[0].sola_buffer)
        assert outs[1].shape == ((block,) if n == 1 else (n, block))
        assert np.abs(outs[1]).max() > 0
        if n > 1:
            assert not outs[1][1].any()
