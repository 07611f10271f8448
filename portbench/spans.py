"""The program's own spans in the device trace of a `--trace 1` run.

With RVC_TPU_TRACE=1 (set by `--trace 1`) every span the program opens
(`rvc_tpu_torch.utils.profiling.trace_span`: pool/step, pool/sola,
train/step, optim/adamw, rmvpe/bigru, kernels/convert_weights, ...) is a
`record_function` range, so it lies in the trace as a `user_annotation` on
the profiler's clock, beside the device operations. `reduce_spans` reads
from the same Chrome-trace events `trace.reduce` reads:

- `host_s_in[name]`: the host seconds of each annotation's intervals (their
  union on each thread, summed over threads);
- `idle_s_in[name]`: the seconds the card sat idle (gaps in the union of
  its kernels, copies and memsets) while the thread that launched the
  operation ending the gap was inside the name's intervals: each gap is
  split by its overlap with them, not named by what ran at its start;
- `launches`: the kernel launch calls in the window (runtime and driver
  events named cudaLaunchKernel* or cuLaunchKernel*; copies and memsets
  are not counted).

`install()` makes `trace.reduce` return them beside its own fields (as the
`Trace`'s attributes `host_s_in`, `idle_s_in`, `launches`), which it
computes as before. A reader of these calls `install()` when it is loaded,
before the window. Where the program opens no such span (an older
checkout), its name is missing and the reader reads nothing.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

from portbench.trace import DEVICE_CATS, _union

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel")


def _overlap(iv: Tuple[List[float], List[float]], a: float, b: float) -> float:
    """The length of [a, b] covered by sorted disjoint intervals (starts, ends)."""
    starts, ends = iv
    total = 0.0
    i = bisect.bisect_right(ends, a)
    while i < len(starts) and starts[i] < b:
        total += min(b, ends[i]) - max(a, starts[i])
        i += 1
    return total


def reduce_spans(events: List[dict]) -> Tuple[Dict[str, float], Dict[str, float], int]:
    """(host_s_in, idle_s_in, launches) of Chrome-trace events (timestamps in
    microseconds)."""
    device, launch_tid, launches = [], {}, 0
    ann: Dict[str, Dict[object, list]] = defaultdict(lambda: defaultdict(list))
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "?")
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        args = ev.get("args") or {}
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur, args.get("correlation")))
        elif cat in ("cuda_runtime", "cuda_driver"):
            if "correlation" in args:
                launch_tid[args["correlation"]] = ev.get("tid")
            launches += name.startswith(LAUNCH_CALLS)
        elif cat == "user_annotation":
            ann[name][ev.get("tid")].append((ts, ts + dur))

    host_s_in: Dict[str, float] = {}
    by_tid: Dict[object, Dict[str, Tuple[list, list]]] = defaultdict(dict)
    for name, threads in ann.items():
        host_s_in[name] = 0.0
        for tid, iv in threads.items():
            merged = _union(iv)
            host_s_in[name] += sum(e - s for s, e in merged) * 1e-6
            by_tid[tid][name] = ([s for s, _ in merged], [e for _, e in merged])

    # the card's idle gaps: between runs of overlapping device operations,
    # each ending at the operation that starts the next run
    idle_s_in = dict.fromkeys(host_s_in, 0.0)
    end = None
    for start, stop, corr in sorted(device, key=lambda d: d[0]):
        if end is not None and start > end:
            for name, iv in by_tid.get(launch_tid.get(corr), {}).items():
                idle_s_in[name] += _overlap(iv, end, start) * 1e-6
        end = stop if end is None else max(end, stop)
    return host_s_in, idle_s_in, launches


def install() -> None:
    """Make `trace.reduce` also return `reduce_spans`' fields (once)."""
    from portbench import trace

    if getattr(trace.reduce, "with_spans", False):
        return
    base = trace.reduce

    def reduce(events: List[dict], window_s: float) -> trace.Trace:
        t = base(events, window_s)
        t.host_s_in, t.idle_s_in, t.launches = reduce_spans(events)
        return t

    reduce.with_spans = True
    trace.reduce = reduce


def host_ms(ctx, names: Iterable[str]) -> Optional[float]:
    """Host milliseconds of the spans `names` a unit of traced work; None
    where the program opened none of them or the window did no work."""
    host = getattr(ctx.trace, "host_s_in", {})
    names = list(names)
    if not ctx.snap.work or not any(n in host for n in names):
        return None
    return 1e3 * sum(host.get(n, 0.0) for n in names) / ctx.snap.work
