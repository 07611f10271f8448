"""`rvc_tpu_torch.utils.profiling` against `rvc_tpu.utils.profiling`: the
span timer's summary on the same clock, `trace_span` off unless
RVC_TPU_TRACE=1, the spans that one conversion opens in each package's
offline pipeline (the fused RMVPE path over two chunks, the staged path
with pm), and `xprof_trace` writing a trace on the CPU. The port's own
records: parents, request ids, threads, the ring, the spans as
`record_function` ranges under a profiler, and K1/K2's weight
conversions (`resblock.cached`) counted and spanned on a miss only."""

import json
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from rvc_tpu.configs import PipelineConfig as JaxPipelineConfig
from rvc_tpu.pipelines.offline import Pipeline as JaxPipeline
from rvc_tpu.pitch import PitchExtractor
from rvc_tpu.utils import profiling as J
from rvc_tpu_torch.configs import PipelineConfig
from rvc_tpu_torch.ops import kernels
from rvc_tpu_torch.ops.kernels import resblock
from rvc_tpu_torch.pipelines.offline import Pipeline
from rvc_tpu_torch.utils import profiling as P
from torch_port_helpers import assert_nested, huberts, rmvpes, span_tree, synthesizers

SR = 32000
CHUNKS = dict(x_pad=1, x_query=1, x_center=2, x_max=3)     # 3.5 s: two chunks, one bucket


def _clock(monkeypatch):
    """time.perf_counter stepping by 1.5 ms, 2.5 ms, 3.5 ms, ... a call, and
    time.perf_counter_ns on the same ticks (the port's spans read it)."""
    ticks = np.cumsum(np.arange(1.5e-3, 1.0, 1e-3))
    seconds, nanos = iter(ticks), iter(np.rint(ticks * 1e9).astype(np.int64))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(seconds)))
    monkeypatch.setattr(time, "perf_counter_ns", lambda: int(next(nanos)))


def test_span_timer_summary_and_dump_equal_reference(monkeypatch):
    summaries = []
    for module in (J, P):
        _clock(monkeypatch)
        timer = module.SpanTimer()
        for name in ("b/second", "a/first", "b/second", "c/third", "b/second"):
            with timer.span(name):
                pass
        summaries.append(timer.summary())
    assert summaries[0] == summaries[1]
    summary = summaries[1]
    assert list(summary) == ["a/first", "b/second", "c/third"]
    assert summary["b/second"]["count"] == 3
    assert set(summary["a/first"]) == {"total_s", "count", "mean_ms"}
    assert json.loads(json.dumps(summary)) == summary


@pytest.fixture
def tracer(monkeypatch):
    """A fresh global tracer, RVC_TPU_TRACE=1."""
    timer = P.SpanTimer()
    monkeypatch.setattr(P, "_GLOBAL", timer)
    monkeypatch.setenv("RVC_TPU_TRACE", "1")
    return timer


def _count_record_function(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    return entered


def test_trace_span_is_off_unless_asked(monkeypatch):
    monkeypatch.delenv("RVC_TPU_TRACE", raising=False)
    timer = P.SpanTimer()
    monkeypatch.setattr(P, "_GLOBAL", timer)
    entered = _count_record_function(monkeypatch)
    with P.trace_request(), P.trace_span("host/post", request=3):
        pass
    monkeypatch.setenv("RVC_TPU_TRACE", "0")
    with P.trace_span("host/post"):
        pass
    assert P.global_tracer() is timer and timer.summary() == {}
    assert timer.spans() == [] and entered == []
    monkeypatch.setenv("RVC_TPU_TRACE", "1")
    with P.trace_span("host/post"):
        pass
    assert timer.summary()["host/post"]["count"] == 1
    assert [s.name for s in timer.spans()] == entered == ["host/post"]


def test_spans_nest_and_share_a_request(tracer):
    """An entry's request id reaches every span under it; a request scope
    (`trace_request`) gives the spans inside one fresh id; each thread
    keeps its own parent stack."""
    def step(k):
        with P.trace_span("pool/step", request=k):
            with P.trace_span("pool/resample_in"):
                pass
            with P.trace_span("pool/dispatch"):
                with P.trace_span("rmvpe/bigru"):
                    pass

    step(7)
    worker = threading.Thread(target=step, args=(8,))
    with P.trace_span("pool/step", request=9):
        worker.start()
        worker.join(timeout=60)
    assert not worker.is_alive()
    with P.trace_request() as rid:
        with P.trace_span("host/highpass"):
            pass
        with P.trace_span("host/post"):
            pass
    with P.trace_span("host/post"):
        pass
    spans = tracer.spans()
    assert_nested(spans)
    assert span_tree(spans) == {"pool/step": 3, "pool/step > pool/resample_in": 2,
                     "pool/step > pool/dispatch": 2,
                     "pool/step > pool/dispatch > rmvpe/bigru": 2,
                     "host/highpass": 1, "host/post": 2}
    assert sorted(s.request for s in spans if s.name == "rmvpe/bigru") == [7, 8]
    assert {s.request for s in spans if s.name.startswith("host/")} == {rid, None}
    assert [s.request for s in spans if s.name == "host/highpass"] == [rid]
    assert len({s.id for s in spans}) == len(spans)
    assert tracer.summary()["pool/step"]["count"] == 3


def test_span_ring_is_bounded():
    timer = P.SpanTimer(ring=4)
    for i in range(6):
        with timer.span(f"s/{i}"):
            pass
    assert [s.name for s in timer.spans()] == ["s/2", "s/3", "s/4", "s/5"]
    assert sum(timer.counts.values()) == 6


def test_spans_are_profiler_annotations(tracer, tmp_path):
    """Under a CPU torch.profiler run each span is a user_annotation of its
    name, around the ops it ran."""
    with P.xprof_trace(str(tmp_path)) as log_dir:
        with P.trace_span("train/step", request=0):
            with P.trace_span("optim/adamw"):
                torch.ones(8, 8) @ torch.ones(8, 8)
    events = json.load(open(os.path.join(log_dir, os.listdir(log_dir)[0])))["traceEvents"]
    ann = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    assert {"train/step", "optim/adamw"} <= set(ann)
    outer, inner = ann["train/step"], ann["optim/adamw"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert any("mm" in e.get("name", "") and inner["ts"] <= e["ts"] <= inner["ts"] + inner["dur"]
               for e in events if e.get("cat") == "cpu_op")


def test_cached_converts_once_a_version(tracer):
    """`resblock.cached` converts on a miss only: one conversion (counted,
    spanned) a version bump of its tensors, none on a hit; inference
    tensors, which have no version, convert on every call."""
    kernels.reset_launches()
    w = torch.ones(2, 3)
    made = []

    def make():
        made.append(1)
        return w * 2

    for _ in range(3):
        resblock.cached("stage", (w,), make)
    assert len(made) == 1 and (kernels.CONVERSIONS["stage"], kernels.CONVERSIONS["step"]) == (1, 0)
    for bump in range(2):
        with torch.no_grad():
            w.add_(1.0)
        for _ in range(2):
            resblock.cached("stage", (w,), make)
    assert len(made) == 3 and kernels.CONVERSIONS["stage"] == 3
    with torch.inference_mode():
        v = torch.ones(2)
    for _ in range(2):
        resblock.cached("step", (v,), lambda: v + 1)
    assert (kernels.CONVERSIONS["stage"], kernels.CONVERSIONS["step"]) == (3, 2)
    assert tracer.summary()["kernels/convert_weights"]["count"] == 5
    kernels.reset_launches()
    assert not any(kernels.CONVERSIONS.values())


@pytest.fixture(scope="module")
def pipelines():
    port_s, jax_s, s_params = synthesizers()
    port_h, jax_h, h_params = huberts()
    port_r, jax_r, r_vars = rmvpes()
    pitch = PitchExtractor("rmvpe", model=SimpleNamespace(model=jax_r, variables=r_vars))
    ref = JaxPipeline(tgt_sr=SR, synthesizer=jax_s, synth_variables={"params": s_params},
                      hubert=jax_h, hubert_variables={"params": h_params},
                      pitch_extractor=pitch, config=JaxPipelineConfig(**CHUNKS))
    return ref, Pipeline(SR, port_s, port_h, port_r, config=PipelineConfig(**CHUNKS))


def _clip(seconds: float) -> np.ndarray:
    rng = np.random.default_rng(5)
    t = np.arange(int(seconds * 16000)) / 16000
    return (0.5 * np.sin(2 * np.pi * (150 * t + 20 * t * t))
            + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


@pytest.mark.parametrize("seconds,f0_method", [(3.5, "rmvpe"), (0.9, "pm")],
                         ids=["fused-two-chunks", "staged-pm"])
def test_pipeline_spans_equal_reference(pipelines, monkeypatch, seconds, f0_method):
    """With RVC_TPU_TRACE=1 one conversion opens the reference's spans,
    name for name and count for count (the JAX package at its CPU default
    of two programs a chunk; its `dispatch/all_program` and batch spans
    belong to dispatch modes the port does not have)."""
    monkeypatch.setenv("RVC_TPU_TRACE", "1")
    monkeypatch.setenv("RVC_TPU_SOURCE_NOISE", "0")
    monkeypatch.setenv("RVC_TPU_F16_IN", "0")
    monkeypatch.setenv("RVC_TPU_F16_OUT", "0")
    counts = []
    for module, pipe in zip((J, P), pipelines):
        monkeypatch.setattr(module, "_GLOBAL", module.SpanTimer())
        kw = dict(index=None, index_rate=0.0) if module is J else {}
        pipe.pipeline(_clip(seconds), sid=1, f0_method=f0_method, volume_envelope=0.5, **kw)
        counts.append({k: v["count"] for k, v in module.global_tracer().summary().items()})
    port_only = {"rmvpe/bigru"}
    assert {k: v for k, v in counts[1].items() if k not in port_only} == counts[0]
    n = 2 if f0_method == "rmvpe" else 1
    want = ({"dispatch/fused_convert": n, "host/pad+upload": n, "dispatch/f0_program": n,
             "dispatch/conv_program": n, "fetch/materialize": n, "rmvpe/bigru": n}
            if f0_method == "rmvpe" else {"host/get_f0": n})
    assert counts[1] == {"host/highpass": 1, "host/post": 1, **want}
    spans = P.global_tracer().spans()
    assert_nested(spans)
    assert len({s.request for s in spans}) == 1 and spans[0].request is not None


def test_xprof_trace_writes_a_trace(tmp_path):
    """On the CPU: a Chrome trace JSON in log_dir, with the annotated
    region and the ops under it."""
    with P.xprof_trace(str(tmp_path / "trace")) as log_dir:
        with P.annotate("rvc/matmul"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(log_dir)
    assert log_dir == str(tmp_path / "trace") and len(files) == 1
    events = json.load(open(os.path.join(log_dir, files[0])))["traceEvents"]
    names = {e.get("name") for e in events}
    assert "rvc/matmul" in names and any("matmul" in str(n) for n in names - {"rvc/matmul"})
