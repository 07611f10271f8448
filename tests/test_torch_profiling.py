"""`rvc_tpu_torch.utils.profiling` against `rvc_tpu.utils.profiling`: the
span timer's summary and dump on the same clock, `trace_span` off unless
RVC_TPU_TRACE=1, the spans that one conversion opens in each package's
offline pipeline (the fused RMVPE path over two chunks, the staged path
with pm), and `xprof_trace` writing a trace on the CPU."""

import json
import os
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
from rvc_tpu_torch.pipelines.offline import Pipeline
from rvc_tpu_torch.utils import profiling as P
from torch_port_helpers import huberts, rmvpes, synthesizers

SR = 32000
CHUNKS = dict(x_pad=1, x_query=1, x_center=2, x_max=3)     # 3.5 s: two chunks, one bucket


def _clock(monkeypatch):
    """time.perf_counter stepping by 1.5 ms, 2.5 ms, 3.5 ms, ... a call."""
    ticks = iter(np.cumsum(np.arange(1.5e-3, 1.0, 1e-3)))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))


def test_span_timer_summary_and_dump_equal_reference(monkeypatch, tmp_path):
    dumps = []
    for module in (J, P):
        _clock(monkeypatch)
        timer = module.SpanTimer()
        for name in ("b/second", "a/first", "b/second", "c/third", "b/second"):
            with timer.span(name):
                pass
        path = tmp_path / f"{module.__name__}.json"
        timer.dump(str(path))
        dumps.append((timer.summary(), path.read_text()))
    assert dumps[0] == dumps[1]
    summary = dumps[1][0]
    assert list(summary) == ["a/first", "b/second", "c/third"]
    assert summary["b/second"]["count"] == 3
    assert set(summary["a/first"]) == {"total_s", "count", "mean_ms"}
    assert json.loads(dumps[1][1]) == summary


def test_trace_span_is_off_unless_asked(monkeypatch):
    monkeypatch.delenv("RVC_TPU_TRACE", raising=False)
    timer = P.SpanTimer()
    monkeypatch.setattr(P, "_GLOBAL", timer)
    with P.trace_span("host/post"):
        pass
    monkeypatch.setenv("RVC_TPU_TRACE", "0")
    with P.trace_span("host/post"):
        pass
    assert P.global_tracer() is timer and timer.summary() == {}
    monkeypatch.setenv("RVC_TPU_TRACE", "1")
    with P.trace_span("host/post"):
        pass
    assert timer.summary()["host/post"]["count"] == 1


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
    assert counts[1] == counts[0]
    n = 2 if f0_method == "rmvpe" else 1
    want = ({"dispatch/fused_convert": n, "host/pad+upload": n, "dispatch/f0_program": n,
             "dispatch/conv_program": n, "fetch/materialize": n} if f0_method == "rmvpe"
            else {"host/get_f0": n})
    assert counts[1] == {"host/highpass": 1, "host/post": 1, **want}


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
