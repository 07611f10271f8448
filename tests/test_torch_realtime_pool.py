"""The port's multi-stream pool (`rvc_tpu_torch.realtime.pool`) on the CPU:
N = 2 streams with their own speaker ids through one batched block
program, against the JAX package's pool on the same small models and
audio, and against two of the port's single-stream `VoiceChanger`s.

Noise is off on both sides (see `test_torch_realtime.py`, whose pairs and
bars this file shares). The JAX block program uploads the convert buffer
in float16 (`rvc_tpu/realtime/core.py:300`); on the second stream the
random RMVPE's salience has a near-tie that this rounding flips to another
peak (one frame, 341.7 Hz against 131.4, from the third block on), and the
NSF source's phase carries the flip into every later sample. So against
the JAX pool the port's upload is rounded through float16 as JAX's is (in
the test only: the port computes in float32), and both streams are held on
every block: the same length, waveform corr > 0.995 and atol 5e-3 (the JAX
pool test's bar against its single streams), the (N, F) pitch state within
1e-3 Hz. The float32 pool is held against the port's single streams
(float32 on both sides), which `test_torch_realtime.py` holds against JAX:
per stream the same bars, the pitch state within 1e-3 Hz on every frame."""

import numpy as np
import pytest
import torch

from rvc_tpu.realtime.pool import VoiceChangerPool as JaxPool
from rvc_tpu_torch.realtime import pool as pool_module
from rvc_tpu_torch.realtime.core import VoiceChanger
from rvc_tpu_torch.realtime.pool import VoiceChangerPool
from rvc_tpu_torch.utils import profiling
from test_torch_realtime import BLOCK, SESSION, _assert_block, _assert_pitch, _clip48, make_pair
from torch_port_helpers import assert_nested, span_tree


@pytest.fixture(scope="module", autouse=True)
def two_threads_no_noise():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RVC_TPU_SOURCE_NOISE", "0")
        mp.setenv("RVC_TPU_RT_FUSED", "1")
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def _streams(n_blocks: int) -> np.ndarray:
    return np.stack([_clip48(n_blocks, seed=0, f_start=150.0),
                     0.75 * _clip48(n_blocks, seed=1, f_start=230.0)])


def test_pool_matches_jax_pool(pair, monkeypatch):
    """Speaker ids (0, 1), +1 semitone, protect 0.33, five blocks, the
    port's upload rounded through float16 as JAX's is; stream 1 falls
    silent under a -40 dB gate after three blocks: its first silent block
    still holds speech in the volume window, and its second is converted
    and zeroed after SOLA, on both sides."""
    upload = pool_module.to_device
    monkeypatch.setattr(pool_module, "to_device", lambda x, device: upload(
        x.astype(np.float16).astype(np.float32), device))
    kw = dict(sids=[0, 1], silent_threshold=-40, **SESSION)
    got_pool, ref_pool = VoiceChangerPool(pair.port, 2, **kw), JaxPool(pair.jax, 2, **kw)
    assert got_pool.block_frame == BLOCK
    streams = _streams(5)
    streams[1, 3 * BLOCK:] = 0.0
    for i in range(5):
        blocks = streams[:, i * BLOCK: (i + 1) * BLOCK]
        got, vols = got_pool.process(blocks, pitch_shift=1.0, protect=0.33)
        ref, ref_vols = ref_pool.process(blocks, pitch_shift=1.0, protect=0.33)
        np.testing.assert_allclose(vols, ref_vols, rtol=1e-6)
        _assert_block(got[0], ref[0], f"block {i} stream 0")
        if i < 4:
            _assert_block(got[1], ref[1], f"block {i} stream 1")
        else:
            assert vols[1] == 0.0 and not got[1].any() and not ref[1].any()
        _assert_pitch(got_pool._pitchf_dev.numpy(), np.asarray(ref_pool._pitchf_dev), 1e-3,
                      f"block {i} pitch state")


def test_pool_matches_single_streams(pair):
    """Each stream of the pool against its own VoiceChanger (the fused
    path, the same sid) over three blocks."""
    pool = VoiceChangerPool(pair.port, 2, sids=[1, 0], silent_threshold=-90, **SESSION)
    singles = [VoiceChanger(pair.port, sid=sid, silent_threshold=-90, **SESSION)
               for sid in (1, 0)]
    streams = _streams(3)
    for i in range(3):
        blocks = streams[:, i * BLOCK: (i + 1) * BLOCK]
        pooled, vols = pool.process(blocks)
        for s in range(2):
            single, vol, _ = singles[s].on_request(blocks[s], index_rate=0.0)
            assert vol == pytest.approx(vols[s], rel=1e-6)
            _assert_block(pooled[s], single, f"block {i} stream {s}")
            np.testing.assert_allclose(pool._pitchf_dev[s].numpy(),
                                       singles[s].vc_model._pitchf_dev[0].numpy(),
                                       rtol=0, atol=1e-3)


def test_pool_checks_its_inputs(pair):
    with pytest.raises(ValueError, match="speaker ids"):
        VoiceChangerPool(pair.port, 2, sids=[0, 1, 2], **SESSION)
    pool = VoiceChangerPool(pair.port, 2, **SESSION)
    with pytest.raises(ValueError, match="blocks"):
        pool.process(np.zeros((3, BLOCK), np.float32))


def test_pool_step_spans(pair, monkeypatch):
    """With RVC_TPU_TRACE=1 each `process` step opens one pool/step, its
    request id the step's number, over the five phases; the block program's
    RMVPE opens its rmvpe/bigru inside pool/dispatch. No K1/K2 weight
    conversion: the kernels' plain versions run on the CPU."""
    monkeypatch.setenv("RVC_TPU_TRACE", "1")
    monkeypatch.setattr(profiling, "_GLOBAL", profiling.SpanTimer())
    pool = VoiceChangerPool(pair.port, 2, sids=[0, 1], silent_threshold=-90, **SESSION)
    streams = _streams(2)
    for i in range(2):
        pool.process(streams[:, i * BLOCK: (i + 1) * BLOCK])
    spans = profiling.global_tracer().spans()
    assert_nested(spans)
    assert span_tree(spans) == {
        "pool/step": 2, "pool/step > pool/resample_in": 2, "pool/step > pool/dispatch": 2,
        "pool/step > pool/dispatch > rmvpe/bigru": 2, "pool/step > pool/readback": 2,
        "pool/step > pool/resample_out": 2, "pool/step > pool/sola": 2}
    assert [s.request for s in spans if s.name == "pool/step"] == [0, 1]
    assert [s.request for s in spans if s.name == "pool/sola"] == [0, 1]
    order = [s.name for s in spans if s.request == 1 and s.parent is not None
             and s.name != "rmvpe/bigru"]
    assert order == ["pool/resample_in", "pool/dispatch", "pool/readback",
                     "pool/resample_out", "pool/sola"]
