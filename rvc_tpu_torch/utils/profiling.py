"""Tracing and profiling helpers (counterpart of `rvc_tpu/utils/profiling.py`).

Host-clock span timers with a JSON dump, which the offline pipeline opens
around its stages when RVC_TPU_TRACE=1 (`trace_span`, summed by
`global_tracer()`), and a device trace: `xprof_trace` runs
`torch.profiler` around a block and writes a Chrome trace (CPU activity,
and CUDA activity where a card is present); `annotate` names a region in
it. A span times the host: device work that a span only queues lands in
the span that waits for it (`fetch/materialize`, or the chunk's span on the
port's path, which reads its chunk back inside `convert_chunk`).
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, Optional


class SpanTimer:
    """Accumulating named wall-clock spans (per-stage pipeline timing)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> Dict[str, dict]:
        return {k: {"total_s": round(v, 4), "count": self.counts[k],
                    "mean_ms": round(1000 * v / max(self.counts[k], 1), 3)}
                for k, v in sorted(self.totals.items())}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


@contextlib.contextmanager
def xprof_trace(log_dir: Optional[str] = None):
    """Capture a torch.profiler trace of the block into `log_dir` (default:
    `rvc_tpu_trace` in the temporary directory) as a Chrome trace JSON;
    yields `log_dir`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "rvc_tpu_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """Named region visible in the `xprof_trace` timeline."""
    import torch

    return torch.profiler.record_function(name)


_GLOBAL = SpanTimer()


def global_tracer() -> SpanTimer:
    """Process-wide tracer used by the pipelines when RVC_TPU_TRACE=1."""
    return _GLOBAL


@contextlib.contextmanager
def trace_span(name: str):
    """Span on the global tracer; no-op unless RVC_TPU_TRACE=1."""
    if os.environ.get("RVC_TPU_TRACE", "0") != "1":
        yield
        return
    with _GLOBAL.span(name):
        yield
