"""A cell, a configuration, a traffic mix and a per-layer metric are found by
their names from files alone: a fixture cell added with new files and new
entries in BENCHMARK.json, no existing file of the benchmark edited."""

import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

from portbench import run


def digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_fixture_cell_from_files(tmp_path):
    shutil.copytree(run.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    spec = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    before = digest(tmp_path / "portbench")
    pkg = tmp_path / "portbench"
    cfg = json.loads((pkg / "configs" / "rvc_v2_48k.json").read_text())
    (pkg / "configs" / "fixture_cfg.json").write_text(json.dumps(cfg))
    traffic = json.loads((pkg / "traffic" / "song_noindex.json").read_text())
    traffic["lengths"]["count"] = 3
    (pkg / "traffic" / "fixture_mix.json").write_text(json.dumps(traffic))
    (pkg / "limits" / "fixture_cfg.fixture_mix.json").write_text(
        json.dumps({"wave_rel_l2_max": 0.5}))
    (pkg / "metrics" / "fixture_metric.py").write_text(
        "def read(ctx):\n    return 2.0 * ctx.snap.work\n")
    spec["configs"].append(dict(spec["configs"][0], name="fixture_cfg",
                                file="portbench/configs/fixture_cfg.json"))
    spec["workloads"].append({"name": "fixture_cfg.fixture_mix", "config": "fixture_cfg",
                              "traffic": "fixture_mix", "chips": 1, "why": "a fixture"})
    spec["per_layer"].append({"name": "fixture_metric", "unit": "s", "better": "lower",
                              "source": "program_counter", "layer": "device",
                              "moves": "audio_s_per_s.song", "workloads": ["fixture_cfg.fixture_mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = """
import json
from portbench import run
from portbench.drivers.common import Layer, Snapshot
spec = run.load_json(run.ROOT / "BENCHMARK.json")
p = run.cell_parts(spec, "fixture_cfg.fixture_mix")
m = run.load_file_module(run.PKG / "metrics" / "fixture_metric.py", "m")
print(json.dumps(dict(driver=p["driver"].__name__, count=p["traffic"]["lengths"]["count"],
                      limit=p["limits"]["wave_rel_l2_max"], sr=p["config"]["data"]["sample_rate"],
                      metric=m.read(Layer(trace=None, snap=Snapshot(work=3.0))),
                      root=str(run.ROOT))))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == dict(driver="portbench.drivers.song", count=3, limit=0.5, sr=48000,
                       metric=6.0, root=str(tmp_path))
    after = digest(pkg)
    assert {k: v for k, v in after.items() if k in before} == before


def test_run_refuses_without_the_program(tmp_path):
    shutil.copytree(run.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    spec = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          spec["workloads"][0]["name"], "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_reader_found_by_the_longest_prefix():
    assert run.reader_path("device_ms.content.song").name == "device_ms.content.py"
    assert run.reader_path("resblock_roofline.train").name == "resblock_roofline.py"
    assert run.reader_path("mfu.batch").name == "mfu.py"


def test_a_reader_names_its_own_range(tmp_path):
    """A metric over a range no driver knows: its reader alone names what to
    wrap; the range opens around each call while on, and observe sees the
    arguments."""
    import torch

    from portbench.drivers.common import Wraps

    (tmp_path / "device_ms.fixture.py").write_text(
        'RANGE = "portbench/fixture"\nWRAP = "pipeline.run"\n'
        'def observe(acc, x):\n    acc["calls"] = acc.get("calls", 0) + x\n'
        'def read(ctx):\n    return ctx.acc[RANGE]["calls"]\n')
    reader = run.load_file_module(tmp_path / "device_ms.fixture.py", "fixture_reader")

    class Pipeline:
        def run(self, x):
            return 2 * x

    pipe = Pipeline()
    wraps = Wraps([reader, reader], {"pipeline": pipe})
    wraps.on()
    with torch.profiler.profile() as prof:
        assert pipe.run(3) == 6
    wraps.off()
    assert pipe.run(4) == 8 and "run" not in vars(pipe)
    assert [e.name for e in prof.events()].count("portbench/fixture") == 1
    assert wraps.acc == {"portbench/fixture": {"calls": 3}}
