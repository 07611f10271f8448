"""The program's spans in the trace (`portbench.spans`) on hand-made Chrome
traces: host seconds per span, device idle split by its overlap with the
spans of the launching thread, launch calls; `trace.reduce`'s own fields
unchanged once extended; the readers of the spans' metrics."""

import pytest

from portbench import run, spans, trace
from portbench.drivers.common import Layer, Snapshot
from portbench.tests.test_portbench_trace import EVENTS, ev

STEP = [
    ev("user_annotation", "pool/step", 0, 300),
    ev("user_annotation", "pool/dispatch", 10, 50),
    ev("user_annotation", "pool/readback", 60, 60),
    ev("user_annotation", "pool/readback", 70, 20),          # nested: counted once
    ev("user_annotation", "pool/sola", 150, 100),
    ev("user_annotation", "pool/sola", 100, 30, tid=2),      # another thread's
    ev("cuda_runtime", "cudaLaunchKernel", 20, 2, corr=1),
    ev("cuda_runtime", "cudaLaunchKernelExC", 30, 2, corr=4),
    ev("cuda_runtime", "cudaMemcpyAsync", 65, 2, corr=2),    # a copy: no launch
    ev("cuda_driver", "cuLaunchKernel", 200, 2, corr=3),
    ev("kernel", "k", 30, 50, tid=7, corr=1),
    ev("kernel", "k", 40, 10, tid=7, corr=4),                # inside the first
    ev("gpu_memcpy", "Memcpy DtoH", 90, 20, tid=7, corr=2),
    ev("kernel", "k", 270, 10, tid=7, corr=3),
]


def test_host_idle_and_launches():
    host, idle, launches = spans.reduce_spans(STEP)
    assert host == {"pool/step": pytest.approx(300e-6), "pool/dispatch": pytest.approx(50e-6),
                    "pool/readback": pytest.approx(60e-6), "pool/sola": pytest.approx(130e-6)}
    # the card idles 80..90 and 110..270 (both gaps end at thread 1's
    # launches); the second overlaps the read-back for 10 us and SOLA on
    # thread 1 for 100 us, and lies in the step whole; thread 2's SOLA, though
    # inside the gap, launched nothing
    assert idle == {"pool/step": pytest.approx(170e-6), "pool/dispatch": 0.0,
                    "pool/readback": pytest.approx(20e-6), "pool/sola": pytest.approx(100e-6)}
    assert launches == 3


def test_a_gap_of_another_thread():
    events = [ev("user_annotation", "rmvpe/bigru", 0, 100, tid=2),
              ev("user_annotation", "pool/sola", 0, 100, tid=1),
              ev("cuda_runtime", "cudaLaunchKernel", 5, 1, tid=1, corr=1),
              ev("cuda_runtime", "cudaLaunchKernel", 60, 1, tid=2, corr=2),
              ev("kernel", "k", 10, 10, tid=7, corr=1),
              ev("kernel", "k", 70, 10, tid=7, corr=2)]
    _, idle, launches = spans.reduce_spans(events)
    assert idle == {"rmvpe/bigru": pytest.approx(50e-6), "pool/sola": 0.0} and launches == 2


def test_reduce_extended_keeps_its_fields(monkeypatch):
    monkeypatch.setattr(trace, "reduce", trace.reduce)
    before = [trace.reduce(events, window_s=400e-6) for events in (EVENTS, STEP)]
    spans.install()
    spans.install()
    assert trace.reduce.with_spans and not hasattr(before[0], "host_s_in")
    for events, b in zip((EVENTS, STEP), before):
        a = trace.reduce(events, window_s=400e-6)
        assert (a.window_s, a.busy_s, a.device_s_in, a.device_ops, a.idle_gaps) == \
            (b.window_s, b.busy_s, b.device_s_in, b.device_ops, b.idle_gaps)
        assert (a.host_s_in, a.idle_s_in, a.launches) == spans.reduce_spans(events)


def _read(metric, t, work):
    reader = run.load_file_module(run.reader_path(metric), f"reader_{metric}")
    return reader.read(Layer(trace=t, snap=Snapshot(work=work)))


def test_readers(monkeypatch):
    monkeypatch.setattr(trace, "reduce", trace.reduce)
    spans.install()
    t = trace.reduce(STEP, window_s=400e-6)
    assert _read("pool_resample_ms.stream", t, 2) is None      # no such span
    assert _read("pool_dispatch_ms.stream", t, 2) == pytest.approx(50e-6 * 1e3 / 2)
    assert _read("pool_readback_ms.stream", t, 2) == pytest.approx(60e-6 * 1e3 / 2)
    assert _read("pool_sola_ms.stream", t, 2) == pytest.approx(130e-6 * 1e3 / 2)
    assert _read("launches.stream", t, 2) == 1.5
    busy = (50 + 20 + 10) * 1e-6
    between = _read("idle_between_steps.stream", t, 2)
    assert between == pytest.approx(100 * (400e-6 - busy - 170e-6) / 400e-6)
    assert between + 100 * 170e-6 / 400e-6 == pytest.approx(100 * (1 - t.busy_s / t.window_s))
    assert _read("f0_gru_idle_ms.song", t, 2) is None
    assert _read("weight_convert_ms.train", t, 2) is None
    steps = STEP + [ev("user_annotation", "train/step", 0, 300),
                    ev("user_annotation", "optim/adamw", 100, 40),
                    ev("user_annotation", "rmvpe/bigru", 100, 200)]
    t = trace.reduce(steps, window_s=400e-6)
    assert _read("weight_convert_ms.train", t, 2) == 0.0
    assert _read("optim_ms.train", t, 2) == pytest.approx(40e-6 * 1e3 / 2)
    assert _read("f0_gru_idle_ms.batch", t, 0.5) == pytest.approx(1e3 * 160e-6 / 0.5)
    # a trace of a program without spans: the span readers read nothing
    t = trace.reduce(EVENTS, window_s=300e-6)
    for m in ("pool_sola_ms.stream", "idle_between_steps.stream", "optim_ms.train",
              "f0_gru_idle_ms.song", "weight_convert_ms.train"):
        assert _read(m, t, 2) is None, m
    assert _read("launches.train", t, 3) == 1.0
