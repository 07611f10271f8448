"""The plain reference against the port on the CPU at small sizes, and the
check against the faults a cell can have: with the timed path broken
underneath, `check` comes out not correct."""

import numpy as np
import pytest
import torch

from portbench.tests import helpers

SONG, LONG, TRAIN = "rvc_v2_48k.song_noindex", "rvc_v2_48k.longform", "rvc_v2_40k.train"
STREAM = "rvc_v2_40k.stream_noindex"


def ok(checks):
    return all(c["ok"] for c in checks.values())


@pytest.mark.parametrize("workload", [SONG, LONG, TRAIN, STREAM])
def test_reference_follows_the_port(workload):
    """float32 on both sides on the host: every number well inside its limit
    (the training step's worst leaf reads ~5e-4 here, PERF.md)."""
    _, checks = helpers.drive(workload)
    assert ok(checks), helpers.dumps(checks)
    for c in checks.values():
        assert c["value"] <= 0.2 * c["limit"], helpers.dumps(checks)


def _alter_answers(obj, meth):
    """Wrap obj.meth so that every answer it produces has its second half
    negated."""
    orig = getattr(obj, meth)

    def altered(*a, **k):
        out = orig(*a, **k)
        n = out.shape[-1] // 2
        out = out.copy() if isinstance(out, np.ndarray) else out.clone()
        out[..., n:] = -out[..., n:]
        return out

    setattr(obj, meth, altered)


def test_song_answer_altered_fails():
    _, checks = helpers.drive(SONG, fault=lambda d: _alter_answers(d.rvc.pipeline,
                                                                    "convert_chunk"))
    assert not ok(checks)


def test_longform_answer_altered_fails():
    _, checks = helpers.drive(LONG, fault=lambda d: _alter_answers(d.bc, "convert_batch"))
    assert not ok(checks)


def test_stream_block_altered_fails():
    _, checks = helpers.drive(STREAM, fault=lambda d: _alter_answers(d.rvc.pipeline,
                                                                      "_synthesize"))
    assert not checks["block_rel_l2_vs_bf16"]["ok"]


def test_stream_answer_altered_fails():
    def fault(d):
        orig = d.pool.process

        def altered(*a, **k):
            outs, vols = orig(*a, **k)
            outs = outs.copy()
            outs[:, outs.shape[1] // 2:] *= -1
            return outs, vols

        d.pool.process = altered

    _, checks = helpers.drive(STREAM, fault=fault)
    assert not checks["sola_max_abs"]["ok"]


def test_train_state_unchanged_fails(monkeypatch):
    from rvc_tpu_torch.train import optim

    monkeypatch.setattr(optim.AdamW, "step", lambda self, grads, gate=None: None)
    _, checks = helpers.drive(TRAIN)
    assert not checks["change_gap_max"]["ok"]


def test_train_half_batch_fails(monkeypatch):
    from rvc_tpu_torch.train import train_step

    orig = train_step.TrainStep.__call__

    def half(self, batch, generator=None, **draws):
        h = batch.phone.shape[0] // 2
        return orig(self, train_step.Batch(*(t[:h] for t in batch)), generator,
                    **{k: v[:h] for k, v in draws.items()})

    monkeypatch.setattr(train_step.TrainStep, "__call__", half)
    _, checks = helpers.drive(TRAIN)
    assert not ok(checks), helpers.dumps(checks)


def _train_losses_altered(scale):
    """A fault on the window's steps: each step's reported losses scaled
    (nan: not finite), its update untouched."""

    def fault(d):
        orig = d.step

        def altered(*a, **k):
            out = dict(orig(*a, **k))
            out["loss_g_total"] = out["loss_g_total"] * scale
            out["loss_d"] = out["loss_d"] * scale
            return out

        d.step = altered

    return fault


def test_train_window_loss_not_finite_fails():
    d, checks = helpers.drive(TRAIN, fault=_train_losses_altered(float("nan")))
    assert d.counts() == (3, 3)
    assert not checks["late_loss_rel"]["ok"]


def test_train_window_loss_altered_fails():
    d, checks = helpers.drive(TRAIN, fault=_train_losses_altered(1.01))
    assert d.counts() == (3, 0)
    assert not checks["late_loss_rel"]["ok"], helpers.dumps(checks)


@pytest.mark.parametrize("workload", [SONG, LONG, TRAIN, STREAM])
@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_control_fails(workload, device):
    """The reference one precision step below the configuration's, in the
    program's place: its numbers fail the limits."""
    from portbench.calibrate import CONTROL
    from portbench.reference import nets

    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = helpers.small(workload)
    d = p["driver"].Driver(p["config"], p["traffic"], 2 ** 31 + 3, torch.device(device))
    d.setup()
    for _ in range(2):
        d.unit()
    d.finish()
    d.release()
    d.check(p["limits"])
    with nets.policy(**CONTROL["train" if workload == TRAIN else "serve"]):
        checks = d.control(p["limits"])
    assert not ok(checks), helpers.dumps(checks)
