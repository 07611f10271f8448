"""The sweep that fixes an open-loop cell's load: the cell's traffic at each
number of streams in turn, in one process, with the latency tail and
whether a backlog grows.

    python3 -m portbench.sweep --workload rvc_v2_40k.stream_noindex \
        --streams 16,32,64,96,128 --seconds 20 --seed 1 [--out chiprun_out/sweep.jsonl]

The workload is named `<config>.<traffic>` and read from its files, so a
cell can be swept before BENCHMARK.json names it. Each line: N, the p50
and p95 block latency (ms), the median step, and the growth of lateness
from the window's first quarter of steps to its last (ms); the knee is the
highest N whose p95 stays under the block's period with no growth. Not
part of a benchmark run.
"""

from __future__ import annotations

import argparse
import copy
import sys
import time

from portbench import run
from portbench.calibrate import emit


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--streams", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    config_name, traffic_name = args.workload.split(".", 1)
    config = run.load_json(run.PKG / "configs" / f"{config_name}.json")
    traffic = run.load_json(run.PKG / "traffic" / f"{traffic_name}.json")
    run.set_env(config, False)
    import importlib

    import numpy as np
    import torch

    run.set_threads(config)
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    for n in (int(s) for s in args.streams.split(",")):
        t = dict(copy.deepcopy(traffic), streams=n)
        d = driver.Driver(config, t, args.seed, torch.device("cuda", 0))
        d.setup()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < args.seconds:
            d.unit()
        d.finish()
        lat = 1e3 * np.asarray(d.latency)
        q = max(len(lat) // 4, 1)
        emit(args.out, dict(streams=n, steps=len(lat), p50_ms=float(np.median(lat)),
                            p95_ms=float(np.percentile(lat, 95)),
                            step_ms_p50=1e3 * float(np.median(d.step_s)),
                            late_growth_ms=float(lat[-q:].mean() - lat[:q].mean()),
                            period_ms=1e3 * d.period))
        d.release()
        del d
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
