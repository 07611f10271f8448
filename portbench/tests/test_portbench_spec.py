"""BENCHMARK.json keeps to the contract's names, units and keys, and every
file it names is there."""

import json
import re

import pytest

from portbench import run
from portbench.tests import helpers

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    spec = helpers.spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert len(json.dumps(spec)) <= 64 * 1024
    assert 1 <= spec["run_seconds"] <= 51 and isinstance(spec["run_seconds"], int)
    assert all(one_line(w) for w in spec["command"]) and len(spec["command"]) <= 32


@pytest.mark.parametrize("key", sorted(KEYS))
def test_entries(key):
    spec = helpers.spec()
    names = [e["name"] for e in spec[key]]
    assert len(names) == len(set(names))
    for e in spec[key]:
        assert set(e) - {"workloads"} == KEYS[key], e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e and key in ("configs", "workloads", "per_layer") and k != "source":
                assert one_line(e[k]), (e["name"], k)


def test_names_resolve_to_files():
    spec = helpers.spec()
    cells = {w["name"] for w in spec["workloads"]}
    e2e = {m["name"] for m in spec["end_to_end"]}
    for w in spec["workloads"]:
        parts = run.cell_parts(spec, w["name"])
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert parts["limits"]
    for m in spec["per_layer"]:
        assert run.reader_path(m["name"]).is_file()
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in spec["end_to_end"])


def test_configs_are_the_published_ones():
    from rvc_tpu_torch.configs import config_to_dict, get_config

    spec = helpers.spec()
    for c in spec["configs"]:
        f = run.load_json(run.ROOT / c["file"])
        want = config_to_dict(get_config(f["data"]["sample_rate"]))
        for part in ("data", "model", "train"):
            got = json.loads(json.dumps(f[part]))
            assert got == json.loads(json.dumps(want[part])), (c["name"], part)
        assert c["reduced"] == f["reduced"] == []
