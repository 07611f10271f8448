"""Run one benchmark cell once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Everything a cell needs is found by the names
in `BENCHMARK.json`: the configuration's file, the traffic file
`portbench/traffic/<traffic>.json`, whose `driver` names the module
`portbench/drivers/<driver>.py` that drives the program's entry and whose
`metric` names the end-to-end metric the driver's quantity is, the
limits `portbench/limits/<cell>.json` of the output check, and for
`--trace 1` a reader per per-layer metric: `portbench/metrics/<prefix>.py`
for the longest prefix of the metric's name, cut at dots, that has a file
(`device_ms.content.song` is read by `device_ms.content.py`). A reader
may name the program callable to run inside its range (`WRAP`,
`drivers.common.Wraps`), so a metric over a new range is a file of its own.

A run: set-up (the program loaded, its weights and inputs made from the
seed, the cell's shapes warmed up), then the window of `--seconds` of
work, then the check of the window's outputs against the plain reference
(after the program is freed), then one JSON line on standard output. With
`--trace 1` the window runs under the profiler and the line carries the
per-layer metrics in place of the end-to-end ones. Exit code 0 only with a
result; without a CUDA device, with JAX or the JAX package loaded, or in a
checkout without the program, the run exits 2 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
CACHE = PKG / "_cache"
# the program's variables of its compute policy and tracing, set only from
# the configuration and the run's mode
PROGRAM_ENV = ("RVC_TPU_BF16", "RVC_TPU_BF16_F0", "RVC_TPU_SOURCE_NOISE", "RVC_TPU_TRACE",
               "RVC_TPU_RT_FUSED")


def fail(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(2)


def finite(v: float) -> float:
    """A number JSON can carry: no comparison (a missing or non-finite
    output) reads as 1e300."""
    return v if v == v and abs(v) != float("inf") else 1e300


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find(spec: dict, key: str, name: str) -> dict:
    for entry in spec[key]:
        if entry["name"] == name:
            return entry
    fail(f"no {key[:-1]} named {name!r} in BENCHMARK.json")


def load_file_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_parts(spec: dict, workload: str, driver: bool = True) -> dict:
    """Everything one cell names, read from its files (with driver=False
    all but the driver's module, which imports numpy and torch)."""
    cell = find(spec, "workloads", workload)
    config = find(spec, "configs", cell["config"])
    traffic = load_json(PKG / "traffic" / f"{cell['traffic']}.json")
    parts = dict(cell=cell, config=load_json(ROOT / config["file"]), traffic=traffic,
                 limits=load_json(PKG / "limits" / f"{workload}.json"))
    if driver:
        parts["driver"] = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    return parts


def reader_path(name: str) -> Path:
    """The reader of a per-layer metric: metrics/<prefix>.py for the
    longest dot-cut prefix of its name that has a file."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        path = PKG / "metrics" / (".".join(parts[:n]) + ".py")
        if path.is_file():
            return path
    fail(f"no reader for the metric {name!r} under portbench/metrics")


def set_env(config: dict, trace: bool) -> None:
    """Caches inside the checkout at fixed paths; the program's switches
    from the configuration only; no JAX through transformers; the host's
    threads as the configuration's policy states them."""
    for k, v in (("TRITON_CACHE_DIR", CACHE / "triton"),
                 ("TORCH_EXTENSIONS_DIR", CACHE / "torch_extensions"),
                 ("CUDA_CACHE_PATH", CACHE / "nv")):
        os.environ[k] = str(v)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if config.get("host_threads"):
        os.environ["OMP_NUM_THREADS"] = str(config["host_threads"])
    for k in PROGRAM_ENV:
        os.environ.pop(k, None)
    os.environ.update({k: str(v) for k, v in config.get("env", {}).items()})
    if trace:
        os.environ["RVC_TPU_TRACE"] = "1"


def set_threads(config: dict) -> None:
    """torch's host threads as the configuration's policy states them
    (`host_threads`; none: the library's default)."""
    import torch

    if config.get("host_threads"):
        torch.set_num_threads(int(config["host_threads"]))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = load_json(ROOT / "BENCHMARK.json")
    parts = cell_parts(spec, args.workload, driver=False)
    set_env(parts["config"], bool(args.trace))
    if not (ROOT / "rvc_tpu_torch").is_dir():
        fail("the program (rvc_tpu_torch) is not in this checkout")

    import gc

    import torch

    set_threads(parts["config"])
    parts = cell_parts(spec, args.workload)

    from portbench import guard
    from portbench.drivers.common import Wraps
    from portbench.trace import Profiler

    if not torch.cuda.is_available() or torch.cuda.device_count() < parts["cell"]["chips"]:
        fail(f"needs {parts['cell']['chips']} CUDA device(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")

    driver = parts["driver"].Driver(parts["config"], parts["traffic"], args.seed,
                                    torch.device("cuda", 0))
    driver.setup()
    torch.cuda.synchronize()
    gc.collect()
    gc.freeze()          # set-up's objects out of the window's collections
    setup_s = time.perf_counter() - T_START

    layer_metrics = [m for m in spec["per_layer"]
                     if args.workload in m.get("workloads", [args.workload])]
    readers = {m["name"]: load_file_module(reader_path(m["name"]), f"portbench_metric_{i}")
               for i, m in enumerate(layer_metrics)}
    prof = Profiler() if args.trace else None
    wraps = Wraps(readers.values(), driver.roots()) if prof else None
    trace_s = float(parts["traffic"].get("trace_seconds", args.seconds))
    traced = None
    if prof:
        driver.annotate(True)
        wraps.on()
        prof.start()
    t0 = time.perf_counter()
    units = 0
    while True:
        driver.unit()
        units += 1
        now = time.perf_counter() - t0
        if prof and traced is None and now >= min(trace_s, args.seconds):
            prof.stop()
            wraps.off()
            driver.annotate(False)
            traced = driver.snapshot()
        if now >= args.seconds:
            break
    driver.finish()
    elapsed = time.perf_counter() - t0

    memory_peak = torch.cuda.max_memory_allocated()
    bad = guard.loaded_forbidden()
    if bad:
        fail(f"forbidden modules loaded: {', '.join(bad)}")

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": parts["cell"]["chips"], "memory_peak_bytes": int(memory_peak)}
    result = {}
    if prof:
        tr = prof.read()
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        ctx = driver.layer_context(tr, traced)
        ctx.acc = wraps.acc
        metrics = {}
        for m in layer_metrics:
            value = readers[m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = {"device_ops": [[n, s] for n, s in tr.device_ops],
                               "idle_gaps": [[n, s] for n, s in tr.idle_gaps]}
    else:
        e2e = {parts["traffic"]["metric"]: driver.end_to_end(elapsed, units), "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in spec["end_to_end"]
                   if args.workload in m.get("workloads", [args.workload])}

    attempted, failed = driver.counts()
    driver.release()
    torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = driver.check(parts["limits"])
    print(f"timing: setup {setup_s:.1f} s, window {elapsed:.1f} s ({units} units), "
          f"check {time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    bad = guard.loaded_forbidden()
    if bad:
        fail(f"forbidden modules loaded: {', '.join(bad)}")
    correct = failed == 0 and all(c["ok"] for c in checks.values())
    card = f"{device['kind']}, power limit {power_limit()}"
    print(f"card: {card}; correct: {correct}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} "
              f"({'ok' if c['ok'] else 'FAILED'})", file=sys.stderr, flush=True)
    line = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
            "device": device, **result, "card": card,
            "checks": {k: {"value": finite(c["value"]), "limit": c["limit"]}
                       for k, c in checks.items()}}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
