"""The RefineGAN long-form cell on the host at small sizes: its check against
the plain reference (`reference/refinegan.py`), which fails when the
program's answers are altered, when the program's decoder computes on bf16
operands, or when the reference one precision step below (the decoder in
bf16) stands in the program's place; its work function against the flop
counter; its readers."""

import copy
from unittest import mock

import numpy as np
import pytest
import torch

from portbench import run, work
from portbench.drivers import longform_refinegan as D
from portbench.drivers.common import Layer, Snapshot
from portbench.reference import refinegan as RG
from portbench.tests import helpers

CELL = "rvc_v2_48k_refinegan.longform"


def small(narrow: bool = True):
    """The cell with short traffic (and the decoder narrowed to 64 channels)."""
    parts = run.cell_parts(helpers.spec(), CELL)
    cfg, tr = copy.deepcopy(parts["config"]), copy.deepcopy(parts["traffic"])
    if narrow:
        cfg["model"]["upsample_initial_channel"] = 64
    tr.update(lengths={"dist": "uniform", "low": 2, "high": 5, "count": 4}, per_job=2,
              chunk_s=1.0, pad_s=0.25, batch_size=2, warmup_s=1)
    return dict(parts, config=cfg, traffic=tr)


def drive(fault=None, seed=2 ** 31 + 11, narrow=True):
    p = small(narrow)
    d = p["driver"].Driver(p["config"], p["traffic"], seed, torch.device("cpu"))
    d.setup()
    if fault is not None:
        fault(d)
    for _ in range(3):
        d.unit()
    d.finish()
    d.release()
    return d, d.check(p["limits"])


def test_reference_follows_the_port():
    d, checks = drive()
    assert len(d.dec_calls) == D.DEC_CALLS
    for c in checks.values():
        assert c["ok"] and c["value"] <= 0.05 * c["limit"], helpers.dumps(checks)


def test_answers_altered_fail():
    def fault(d):
        orig = d.bc.convert_batch

        def altered(*a, **k):
            out = orig(*a, **k).clone()
            out[..., out.shape[-1] // 2:] *= -1
            return out

        d.bc.convert_batch = altered

    _, checks = drive(fault)
    assert not checks["wave_rel_l2_max"]["ok"]


def test_decoder_in_bf16_fails():
    """The program's decoder convolutions on bf16-rounded operands (its
    activations and weights), the rest of the program as it is: the
    decoder's own number sees it."""
    from rvc_tpu_torch.models import layers
    from rvc_tpu_torch.utils.device import compute_dtype

    conv = layers.conv_ops.conv1d

    def rounded(x, w, *a, **k):
        return conv(x.to(torch.bfloat16).float(), w.to(torch.bfloat16).float(), *a, **k)

    def fault(d):
        dec = d.rvc.pipeline.models(compute_dtype(d.device))[1].dec
        inner = dec.forward

        def forward(*a, **k):
            with mock.patch.object(layers.conv_ops, "conv1d", rounded):
                return inner(*a, **k)

        dec.forward = forward

    _, checks = drive(fault)
    assert not checks["decoder_rel_l2_max"]["ok"], helpers.dumps(checks)


def test_control_fails():
    """The reference one precision step below the configuration's in the
    program's place (its decoder in bf16, HuBERT and the prior in fp8, the
    f0 program in bf16): the decoder's own number fails its limit (the
    whole waveform's is for the path's gross faults). At the published
    width: a 64-channel decoder moves less."""
    from portbench.calibrate import CONTROL
    from portbench.reference import nets

    p = small(narrow=False)
    d, _ = drive(narrow=False)
    with nets.policy(**CONTROL["serve"]):
        checks = d.control(p["limits"])
    assert not checks["decoder_rel_l2_max"]["ok"], helpers.dumps(checks)


@pytest.mark.parametrize("shape", [(2, 30, 64, 12), (1, 50, 32, 2)])
def test_stage_work_matches_the_counter(shape):
    B, T, C, rate = shape
    with torch.device("meta"):
        block = RG.ParallelResBlock(C + C // 4, C // 2)
        x, skip = torch.zeros(B, C, T), torch.zeros(B, C // 4, T * rate)
    counted = work.counted_flop(RG.stage, x, skip, rate, block, RG.Noise(None, None))
    flop, nbytes = D.stage_work(B, T, C, rate)
    assert counted == flop
    weights = sum(p.numel() for p in block.parameters())
    assert nbytes == 4 * (B * (T * C + T * rate * (C // 4 + C // 2)) + weights)


def test_decoder_flop_counts_the_stages():
    """The whole decoder's counted FLOP: the stages' by `stage_work` plus the
    convolutions around them."""
    cfg = small()["config"]
    with torch.device("meta"):
        dec = RG.build(cfg).dec
        T = 20
        counted = work.counted_flop(dec, torch.zeros(1, 192, T), torch.ones(1, T),
                                    torch.zeros(1, 256, 1))
    stages, t, c = 0, T, cfg["model"]["upsample_initial_channel"]
    for rate in cfg["model"]["upsample_rates"]:
        stages += D.stage_work(1, t, c, rate)[0]
        t, c = t * rate, c // 2
    assert stages < counted < 1.2 * stages


def test_readers():
    trace = type("T", (), {})()
    trace.device_s_in = {"decoder/source": 0.5, "decoder/stage": 1.5}
    ctx = Layer(trace=trace, snap=Snapshot(work=100.0),
                acc={"portbench/refine_stage": {"bound_s": 0.3}})
    read = {n: run.load_file_module(run.reader_path(n), n).read
            for n in ("device_ms.decoder.batch", "device_ms.decoder_source.batch",
                      "decoder_roofline.batch")}
    assert read["device_ms.decoder.batch"](ctx) == pytest.approx(20.0)
    assert read["device_ms.decoder_source.batch"](ctx) == pytest.approx(5.0)
    assert read["decoder_roofline.batch"](ctx) == pytest.approx(20.0)
    trace.device_s_in = {}                   # a program without the spans
    assert all(r(Layer(trace=trace, snap=Snapshot(work=1.0))) is None for r in read.values())


def test_roofline_observes_the_stage():
    from rvc_tpu_torch.models import generators_extra as G

    reader = run.load_file_module(run.reader_path("decoder_roofline.batch"), "roofline")
    acc = {}
    x, skip = torch.zeros(2, 30, 64), torch.zeros(2, 360, 16)
    reader.observe(acc, x, skip, 12, None, 0.2)
    flop, nbytes = D.stage_work(2, 30, 64, 12, 360)
    assert acc["bound_s"] == pytest.approx(max(flop / work.PEAK_F32, nbytes / work.PEAK_HBM))
    assert reader.WRAP.rsplit(".", 1)[1] in vars(G)


def test_seeded_weights_scales():
    cfg = small()["config"]
    with torch.device("meta"):
        shell = RG.build(cfg)
    sd = D.make(shell.to_empty(device="cpu"), 7, "cpu", 2)
    adain = [v for k, v in sd.items() if k.endswith(".0.weight") and v.dim() == 1]
    assert adain and float(torch.cat(adain).std()) == pytest.approx(D.ADAIN_STD, rel=0.3)
    w = sd["dec.upsample_conv_blocks.1.blocks.0.1.convs1.0.weight"]
    want = D.STAGE_GAIN * (3 * w.shape[1] * w.shape[2]) ** -0.5
    assert float(w.std()) == pytest.approx(want, rel=0.1)
    assert np.isfinite(sum(float(v.sum()) for v in sd.values()))
