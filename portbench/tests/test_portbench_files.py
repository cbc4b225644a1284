"""Every file the benchmark finds by name is there and loads, and
``BENCHMARK.json`` keeps to the contract's shape."""

import json
import os
import re

import pytest

from conftest import CELLS, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]] + [
        w["name"] for w in b["workloads"]] + [
        m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len({m["name"] for m in b["end_to_end"] + b["per_layer"]}) == len(
        b["end_to_end"]) + len(b["per_layer"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        assert set(m["workloads"]) <= cells
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load(cell):
    from portbench import harness

    spec = harness.load_spec(ROOT, cell)
    run = harness.Run(spec, 1, 1.0, False, __import__("torch").device("cpu"))
    assert run.job.name == spec["traffic"]["job"]
    gen = __import__(f"portbench.gen.{spec['traffic']['generator']}",
                     fromlist=["make"])
    assert callable(gen.make)
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.load_reader(m["name"]).read)
    assert spec["per_layer"], "every cell reports a per-layer metric"
    assert len(spec["end_to_end"]) >= 2


@pytest.mark.parametrize("cell", CELLS)
def test_config_file_states_its_cuts(cell):
    b = bench()
    w = {x["name"]: x for x in b["workloads"]}[cell]
    entry = {c["name"]: c for c in b["configs"]}[w["config"]]
    with open(os.path.join(ROOT, entry["file"])) as f:
        config = json.load(f)
    assert config["name"] == entry["name"]
    assert config["reduced"] == entry["reduced"]
    for key in entry["reduced"]:
        assert key in config["published"]
    assert config["dtype"] == "float32" and config["tf32"] is False


def test_every_reader_file_is_a_metric():
    b = bench()
    metrics = {m["name"] for m in b["end_to_end"] + b["per_layer"]}
    files = {f[:-3] for f in os.listdir(os.path.join(ROOT, "portbench",
                                                     "metrics"))
             if f.endswith(".py") and f != "__init__.py"}
    assert files == metrics
