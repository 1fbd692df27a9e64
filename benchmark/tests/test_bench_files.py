"""Every file of the benchmark loads, and every name resolves."""

import json
import os
import re

import pytest

from benchmark import harness

BENCH = os.path.join(harness.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(BENCH) as fh:
        return json.load(fh)


def test_top_level_keys_and_limits():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(BENCH) <= 64 * 1024
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["name"] for w in bench["workloads"]]
    names += [c["name"] for c in bench["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("index", range(3))
def test_each_workload_resolves(index):
    bench = _bench()
    w = bench["workloads"][index]
    cell = harness.Cell(w["name"])
    assert cell.workload["config"] == w["config"]
    assert cell.workload["traffic"] == w["traffic"]
    assert cell.workload["chips"] == w["chips"] == 1
    assert cell.workload["why"] == w["why"] and len(w["why"]) <= 200
    driver = cell.mix["driver"]
    assert os.path.exists(os.path.join(harness.HERE, "traffic",
                                       f"{driver}.py"))
    e2e = {m["name"] for m in cell.end_to_end()}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer()
    for m in cell.per_layer():
        assert m["moves"] in e2e


def test_configs_files_and_sources():
    bench = _bench()
    for c in bench["configs"]:
        path = os.path.join(harness.ROOT, c["file"])
        with open(path) as fh:
            cfg = json.load(fh)
        assert cfg["source"] == c["source"] and len(c["source"]) <= 200
        assert cfg["reduced"] == c["reduced"] == []
        assert os.path.exists(os.path.join(harness.HERE,
                                           cfg["weights"]["serve"]))
        assert cfg["model"]["compute_dtype"] == cfg["policy"][
            "compute_dtype"]
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}


def test_metrics_have_readers_and_fields():
    bench = _bench()
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= cells
        reader = harness.load_module(
            os.path.join(harness.HERE, "metrics", f"{m['name']}.py"),
            m["name"])
        assert reader.read({}) is None      # nothing to read: no number
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
