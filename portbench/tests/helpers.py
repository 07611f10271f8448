"""Small cells for the benchmark's CPU tests: the cells' own drivers on
short traffic (and, for training, a narrow model), on the host."""

from __future__ import annotations

import copy
import json
from pathlib import Path

import torch

from portbench import run

ROOT = Path(__file__).resolve().parents[2]


def spec() -> dict:
    return run.load_json(ROOT / "BENCHMARK.json")


def small(workload: str) -> dict:
    """The cell's parts with its traffic shrunk to seconds of audio or a few
    short training rows (the training model narrowed)."""
    parts = run.cell_parts(spec(), workload)
    cfg, tr = copy.deepcopy(parts["config"]), copy.deepcopy(parts["traffic"])
    if tr["driver"] == "song":
        tr.update(lengths={"dist": "uniform", "low": 3, "high": 4, "count": 2}, warmup_s=2)
    elif tr["driver"] == "longform":
        tr.update(lengths={"dist": "uniform", "low": 2, "high": 5, "count": 4}, per_job=2,
                  chunk_s=1.0, pad_s=0.25, batch_size=2, warmup_s=1)
    elif tr["driver"] == "stream":
        tr.update(streams=3, clip_s=3.0, warmup_steps=1)
    elif tr["driver"] == "train":
        cfg["model"].update(n_layers=1, upsample_initial_channel=64, hidden_channels=64,
                            filter_channels=128, inter_channels=32)
        tr.update(batch=2, frames=48, pool=3, short_frames=[36, 48])
    return dict(parts, config=cfg, traffic=tr)


def drive(workload: str, seed: int = 2 ** 31 + 11, units: int = 3, fault=None):
    """Set-up, `units` units of work, the program freed, the check:
    (driver, checks). `fault(driver)` runs after set-up, to break the timed
    path underneath."""
    p = small(workload)
    torch.manual_seed(0)
    d = p["driver"].Driver(p["config"], p["traffic"], seed, torch.device("cpu"))
    d.setup()
    if fault is not None:
        fault(d)
    for _ in range(units):
        d.unit()
    d.finish()
    d.release()
    return d, d.check(p["limits"])


def dumps(obj) -> str:
    return json.dumps(obj, indent=1)
