"""Tracing and profiling helpers (counterpart of `rvc_tpu/utils/profiling.py`).

The port's one span tracer, and a device trace. With RVC_TPU_TRACE=1 the
program opens named spans where its work happens (`trace_span`):

- the offline pipeline: host/highpass, dispatch/fused_convert and inside
  it host/pad+upload, dispatch/f0_program, dispatch/conv_program and
  fetch/materialize (the chunk's read-back), host/get_f0, host/post;
- the realtime pool: pool/step, and inside it pool/resample_in,
  pool/dispatch, pool/readback, pool/resample_out, pool/sola;
- the training step: train/step, and inside it train/g_forward,
  train/g_backward, optim/adamw (G's update) and train/d_update (with D's
  optim/adamw); on several ranks dp/all_reduce and dp/all_gather around
  the data axis's collectives (`parallel.train`);
- RefineGAN's decoder: decoder/source, and decoder/stage around each
  upsampling stage;
- rmvpe/bigru around RMVPE's recurrence, kernels/convert_weights around a
  K1/K2 weight conversion (a miss of `ops.kernels.resblock.cached`).

Each span adds to the global tracer's totals and counts (`summary()`) and
keeps a record (`Span`: name, start and end on `time.perf_counter_ns`, its
parent on the same thread, its request id) in a bounded ring, read by
`global_tracer().spans()`. An entry names the request: a song's
`Pipeline.pipeline` call (`trace_request`), a pool step and a training
step (by their step numbers); the spans under it carry its id. Each span
also opens `torch.profiler.record_function(name)`, so under a profiler it
lies in the device trace on the profiler's clock, beside the kernels it
launched. With tracing off a span is one flag check.

A span times the host: device work that a span only queues lands in the
span that waits for it (`fetch/materialize`, `pool/readback`). `xprof_trace`
runs `torch.profiler` around a block and writes a Chrome trace (CPU
activity, and CUDA activity where a card is present); `annotate` names a
region in it.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import tempfile
import threading
import time
from collections import defaultdict, deque
from typing import Dict, Hashable, List, NamedTuple, Optional

import torch

# records kept: a song window of ~40 chunks opens ~300 spans, a training
# step ~25 (K1/K2 conversions included), a pool step 7
RING = 1 << 16


class Span(NamedTuple):
    """One closed span."""
    id: int
    name: str
    start_ns: int                 # time.perf_counter_ns
    end_ns: int
    parent: Optional[int]         # the enclosing span on the same thread
    request: Optional[Hashable]   # the entry's request id, inherited
    thread: int


class SpanTimer:
    """Named wall-clock spans: totals and counts by name (per-stage
    pipeline timing), and the last `ring` records with their parents and
    request ids."""

    def __init__(self, ring: int = RING):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._records: deque = deque(maxlen=ring)
        self._ids = itertools.count(1)
        self._requests = itertools.count(1)
        self._local = threading.local()     # this thread's open spans and request
        self._lock = threading.Lock()

    def _thread(self):
        local = self._local
        if not hasattr(local, "stack"):
            local.stack, local.request = [], None
        return local

    @contextlib.contextmanager
    def request(self, request: Optional[Hashable] = None):
        """Spans opened inside, on this thread, carry `request` (None: the
        next of this tracer's own ids)."""
        local = self._thread()
        prev = local.request
        local.request = next(self._requests) if request is None else request
        try:
            yield local.request
        finally:
            local.request = prev

    @contextlib.contextmanager
    def span(self, name: str, request: Optional[Hashable] = None):
        """Time the block as `name`; with `request`, the block and the spans
        inside it carry that request id, else the enclosing one's."""
        local = self._thread()
        prev = local.request
        if request is not None:
            local.request = request
        sid = next(self._ids)
        parent = local.stack[-1] if local.stack else None
        local.stack.append(sid)
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            t1 = time.perf_counter_ns()
            local.stack.pop()
            rid, local.request = local.request, prev
            with self._lock:
                self.totals[name] += (t1 - t0) * 1e-9
                self.counts[name] += 1
            self._records.append(Span(sid, name, t0, t1, parent, rid, threading.get_ident()))

    def spans(self) -> List[Span]:
        """The kept records, oldest first (a span is kept when it closes)."""
        return list(self._records)

    def summary(self) -> Dict[str, dict]:
        return {k: {"total_s": round(v, 4), "count": self.counts[k],
                    "mean_ms": round(1000 * v / max(self.counts[k], 1), 3)}
                for k, v in sorted(self.totals.items())}


@contextlib.contextmanager
def xprof_trace(log_dir: Optional[str] = None):
    """Capture a torch.profiler trace of the block into `log_dir` (default:
    `rvc_tpu_trace` in the temporary directory) as a Chrome trace JSON;
    yields `log_dir`."""
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
    return torch.profiler.record_function(name)


_GLOBAL = SpanTimer()
_OFF = contextlib.nullcontext()


def global_tracer() -> SpanTimer:
    """Process-wide tracer used by the program when RVC_TPU_TRACE=1."""
    return _GLOBAL


def _enabled() -> bool:
    return os.environ.get("RVC_TPU_TRACE", "0") == "1"


@contextlib.contextmanager
def _traced(name: str, request: Optional[Hashable]):
    with _GLOBAL.span(name, request), torch.profiler.record_function(name):
        yield


def trace_span(name: str, request: Optional[Hashable] = None):
    """Span on the global tracer and a `record_function` range of the same
    name; a no-op unless RVC_TPU_TRACE=1. `request`: the id the span and the
    spans under it carry (an entry's; else the enclosing request's)."""
    if not _enabled():
        return _OFF
    return _traced(name, request)


def trace_request(request: Optional[Hashable] = None):
    """The request id of the spans opened inside on this thread (None: the
    global tracer's next id); a no-op unless RVC_TPU_TRACE=1."""
    if not _enabled():
        return _OFF
    return _GLOBAL.request(request)
