"""The four-rank training cell on the host: four gloo ranks at small widths
through `drivers.train_dp`, its check against the reference on the global
batch, and the faults it must see (a rank with a stale parameter, a rank
on half its rows, a rank that dies)."""

import copy
import os
import subprocess
import sys

import pytest
import torch

from portbench import run
from portbench.tests import helpers

CELL = "rvc_v2_40k.train_dp4"


def small():
    parts = run.cell_parts(helpers.spec(), CELL)
    cfg, tr = copy.deepcopy(parts["config"]), copy.deepcopy(parts["traffic"])
    cfg["model"].update(n_layers=1, upsample_initial_channel=64, hidden_channels=64,
                        filter_channels=128, inter_channels=32)
    cfg["host_threads"] = 1
    tr.update(batch=2, frames=48, pool=3, short_frames=[36, 48])
    return dict(parts, config=cfg, traffic=tr)


def drive(fault=None, units=2):
    p = small()
    d = p["driver"].Driver(p["config"], p["traffic"], 2 ** 31 + 11, torch.device("cpu"))
    d.setup()
    try:
        if fault is not None:
            d.on_ranks(fault)
        for _ in range(units):
            d.unit()
        d.finish()
    finally:
        d.release()
    return d, d.check(p["limits"])


def stale(rank):
    """Rank 2's first parameter moved by 1e-3 (the others untouched)."""
    if rank.rank == 2:
        with torch.no_grad():
            next(rank.trainer.net_g.parameters()).add_(1e-3)


def half_rows(rank):
    """Rank 1 steps on the first half of its rows."""
    if rank.rank == 1:
        h = rank.traffic["batch"] // 2
        rank.pool = [{k: v[:h] for k, v in b.items()} for b in rank.pool]
        rank.draws = [type(d)(*(x[:h] for x in d)) for d in rank.draws]


def test_four_ranks_follow_the_reference():
    d, checks = drive()
    assert all(c["ok"] for c in checks.values()), helpers.dumps(checks)
    assert checks["rank_param_max_abs"]["value"] == 0.0
    assert d.counts() == (2, 0)


@pytest.mark.parametrize("fault,check", [
    ("portbench.tests.test_portbench_train_dp:stale", "rank_param_max_abs"),
    ("portbench.tests.test_portbench_train_dp:half_rows", "late_loss_rel")])
def test_faults_fail(fault, check):
    _, checks = drive(fault)
    assert not checks[check]["ok"], helpers.dumps(checks)


def die(rank):
    if rank.rank == 3:
        os._exit(9)


def test_a_dead_rank_ends_the_run():
    """A rank that dies mid-run ends the benchmark's process with exit code
    2 and no result, instead of leaving rank 0 in a collective."""
    code = f"""
import torch
from portbench.tests import test_portbench_train_dp as T
p = T.small()
d = p["driver"].Driver(p["config"], p["traffic"], 5, torch.device("cpu"))
d.setup()
d.on_ranks("portbench.tests.test_portbench_train_dp:die")
for _ in range(50):
    d.unit()
d.finish()
print("finished")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=helpers.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 2 and "finished" not in out.stdout, out.stderr[-2000:]
    assert "rank 3 ended" in out.stderr
