"""Readings that set a cell's limits: the program's check numbers over many
seeds, and the lower-precision control's, in one process.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 --seconds 10 \
        [--control 3] [--program-env RVC_TPU_BF16_F0=1] [--out chiprun_out/x.jsonl]

For each seed: the cell's set-up, a window of `--seconds` at the cell's own
load, the program freed, the check against the float32 reference (one line
`{"seed", "kind": "program", numbers}`). For the first `--control` seeds
also the control: the same reference put in the program's place, computed
one precision step below what the configuration states (`CONTROL`), on the
same items (`"kind": "control"`); for a training cell also the reference
with half of each batch left out, the mean over the rest (`"kind":
"half_batch"`). `--program-env` runs the program with those variables set
(the program's own lower-precision path as a control, `"kind":
"program_env"`). Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from portbench import run

# one step below the configuration's precision in each part: float32 parts
# (the f0 program, training) to bf16; bf16 parts (HuBERT, enc_p and the
# flow) to fp8; the decoder's float32 on bf16-rounded weights to bf16
CONTROL = {"serve": dict(f0="bf16", content="fp8", prior="fp8", dec="bf16"),
           "train": dict(prior="bf16", post="bf16", dec="bf16", disc="bf16")}


def emit(out, obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def numbers(checks: dict) -> dict:
    return {k: v["value"] for k, v in checks.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--program-env", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    spec = run.load_json(run.ROOT / "BENCHMARK.json")
    parts = run.cell_parts(spec, args.workload, driver=False)
    run.set_env(parts["config"], False)
    if args.program_env:
        k, v = args.program_env.split("=", 1)
        os.environ[k] = v
    import torch

    from portbench.reference import nets

    run.set_threads(parts["config"])
    parts = run.cell_parts(spec, args.workload)
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    kind = "program_env" if args.program_env else "program"
    for n, seed in enumerate(seeds):
        t0 = time.perf_counter()
        d = parts["driver"].Driver(parts["config"], parts["traffic"], seed, device)
        d.setup()
        setup_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        units = 0
        while time.perf_counter() - t1 < args.seconds:
            d.unit()
            units += 1
        d.finish()
        e2e = {parts["traffic"]["metric"]: d.end_to_end(time.perf_counter() - t1, units)}
        d.release()
        torch.cuda.empty_cache()
        t2 = time.perf_counter()
        checks = d.check(parts["limits"])
        emit(args.out, dict(seed=seed, kind=kind, **numbers(checks), setup_s=setup_s, **e2e,
                            units=units, check_s=time.perf_counter() - t2,
                            memory_peak_bytes=torch.cuda.max_memory_allocated(),
                            env=args.program_env))
        if n < args.control and not args.program_env:
            train = args.workload.endswith(".train")
            with nets.policy(**CONTROL["train" if train else "serve"]):
                emit(args.out, dict(seed=seed, kind="control", **numbers(d.control(parts["limits"]))))
            if train:
                emit(args.out, dict(seed=seed, kind="half_batch",
                                    **numbers(d.control(parts["limits"], half_batch=True))))
        del d
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
