"""The device trace of a `--trace 1` run and the reductions per-layer
metrics read from it.

The window runs under `torch.profiler` (CPU and CUDA activity); the Chrome
trace it exports (into the run's TMPDIR, deleted after reading) is reduced
to:
- device intervals: every kernel, copy and memset on the card;
- `busy_s`: the union of those intervals inside the window;
- ranges: the host intervals of each `record_function` name the benchmark
  opened, and each range's device seconds (the kernels whose launch, by the
  trace's correlation id, happened inside one of its intervals on the same
  host thread);
- `breakdown`: the ten device operations that took most time, and the ten
  host activities (the innermost annotation or operator running on the
  launching thread) under which the device sat idle longest.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op")


@dataclass
class Trace:
    window_s: float
    busy_s: float
    device_s_in: Dict[str, float]                 # range name -> device seconds
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


class Profiler:
    """`start()` / `stop()` around the window; `read()` reduces the trace."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.torch = torch
        self.t0 = self.t1 = 0.0

    def start(self) -> None:
        self.torch.cuda.synchronize()
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        self.torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def read(self) -> Trace:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.unlink(path)
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        return reduce(events, self.t1 - self.t0)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce(events: List[dict], window_s: float) -> Trace:
    """Reduce Chrome-trace events (timestamps in microseconds)."""
    device, launches, host = [], {}, defaultdict(list)
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        args = ev.get("args") or {}
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur, ev.get("name", "?"), args.get("correlation")))
        elif cat in ("cuda_runtime", "cuda_driver"):
            if "correlation" in args:
                launches[args["correlation"]] = (ts, ev.get("tid"))
        elif cat in HOST_CATS:
            host[ev.get("tid")].append((ts, ts + dur, ev.get("name", "?"), cat))
    merged = _union([(s, e) for s, e, _, _ in device])
    busy = sum(e - s for s, e in merged) * 1e-6

    # each annotated range: sorted intervals per thread, and the device time
    # of the kernels launched inside them
    ranges: Dict[str, Dict[object, Tuple[list, list]]] = defaultdict(dict)
    for tid, evs in host.items():
        by_name = defaultdict(list)
        for s, e, name, cat in evs:
            if cat == "user_annotation":
                by_name[name].append((s, e))
        for name, iv in by_name.items():
            iv.sort()
            ranges[name][tid] = ([s for s, _ in iv], [e for _, e in iv])
    device_in: Dict[str, float] = defaultdict(float)
    per_kernel: Dict[str, float] = defaultdict(float)
    for s, e, name, corr in device:
        per_kernel[name] += (e - s) * 1e-6
        launch = launches.get(corr)
        if launch is None:
            continue
        ts, tid = launch
        for rname, by_tid in ranges.items():
            iv = by_tid.get(tid)
            if iv is None:
                continue
            i = bisect.bisect_right(iv[0], ts) - 1
            if i >= 0 and iv[1][i] >= ts:
                device_in[rname] += (e - s) * 1e-6

    # idle gaps, labelled by the innermost host activity at the gap's start
    # on the thread that launched the next device operation
    gaps: Dict[str, float] = defaultdict(float)
    host_sorted = {tid: sorted(evs) for tid, evs in host.items()}
    starts = {tid: [s for s, _, _, _ in evs] for tid, evs in host_sorted.items()}
    dev_sorted = sorted(device)
    for (_, end_prev, _, _), (start_next, _, _, corr) in zip(dev_sorted, dev_sorted[1:]):
        if start_next <= end_prev:
            continue
        tid = launches.get(corr, (None, None))[1]
        label = "(no host activity traced)"
        evs = host_sorted.get(tid)
        if evs:
            i = bisect.bisect_right(starts[tid], end_prev) - 1
            best = None
            while i >= 0 and i >= bisect.bisect_right(starts[tid], end_prev) - 64:
                s, e, name, _ = evs[i]
                if s <= end_prev <= e and (best is None or s >= best[0]):
                    best = (s, name)
                i -= 1
            if best is not None:
                label = best[1]
        gaps[label] += (start_next - end_prev) * 1e-6
    top_ops = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return Trace(window_s=window_s, busy_s=busy, device_s_in=dict(device_in),
                 device_ops=top_ops, idle_gaps=top_gaps)
