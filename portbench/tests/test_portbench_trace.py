"""The trace reduction on a hand-made Chrome trace."""

import pytest

from portbench import trace


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    ev("user_annotation", "portbench/f0_program", 0, 100),
    ev("cpu_op", "aten::conv2d", 5, 20),
    ev("cuda_runtime", "cudaLaunchKernel", 10, 2, corr=1),
    ev("cuda_runtime", "cudaLaunchKernel", 30, 2, corr=2),
    ev("cpu_op", "aten::copy_", 150, 100),
    ev("cuda_runtime", "cudaLaunchKernel", 160, 2, corr=3),
    ev("kernel", "conv_kernel", 20, 50, tid=7, corr=1),
    ev("kernel", "conv_kernel", 60, 30, tid=7, corr=2),      # overlaps the first
    ev("kernel", "copy_kernel", 200, 10, tid=7, corr=3),
]


def test_reduce():
    t = trace.reduce(EVENTS, window_s=300e-6)
    assert t.busy_s == pytest.approx((70 + 10) * 1e-6)
    assert t.device_s_in == {"portbench/f0_program": pytest.approx(80e-6)}
    assert t.device_ops[0] == ("conv_kernel", pytest.approx(80e-6))
    # the gap 90..200 us: the next kernel was launched on thread 1, which at
    # 90 us was inside the f0 range (aten::copy_ starts later)
    assert t.idle_gaps == [("portbench/f0_program", pytest.approx(110e-6))]
