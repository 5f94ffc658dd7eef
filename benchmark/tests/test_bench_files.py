"""BENCHMARK.json and the files it names: they parse, keep to the
contract's names and limits, and agree with each other."""

import importlib
import importlib.util
import json
import os
import re

import pytest

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in SPEC["workloads"]]


def load(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    # a full check of 24 cells (14 runs each, 2 more, compiles and spare)
    # fits in 43200 s at this run length
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_names_units_and_uniqueness():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for group in (SPEC["configs"], SPEC["workloads"], metrics):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in SPEC["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_end_to_end_bounds():
    names = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in names
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}


def reported(cell):
    return {m["name"] for m in SPEC["end_to_end"]
            if cell in m.get("workloads", CELLS)}


@pytest.mark.parametrize("metric", SPEC["per_layer"],
                         ids=[m["name"] for m in SPEC["per_layer"]])
def test_per_layer_metric(metric):
    assert set(metric) == {"name", "unit", "better", "source", "layer",
                           "moves", "workloads"}
    assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
    for cell in metric["workloads"]:
        assert metric["moves"] in reported(cell)
    path = os.path.join(BENCH, "metrics", metric["name"] + ".py")
    spec = importlib.util.spec_from_file_location("m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.read({"kind": "i2v", "items": []}) is None


def test_every_cell_reports_enough():
    for cell in CELLS:
        e2e = reported(cell)
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(cell in m["workloads"] for m in SPEC["per_layer"])


@pytest.mark.parametrize("entry", SPEC["configs"],
                         ids=[c["name"] for c in SPEC["configs"]])
def test_config_file(entry):
    from entries.i2v import port_config

    assert entry["file"] == f"benchmark/configs/{entry['name']}.json"
    cfg = load("configs", entry["name"] + ".json")
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert any(w["config"] == entry["name"] for w in SPEC["workloads"])
    port_config(cfg)        # every group's keys are the program's


@pytest.mark.parametrize("cell", CELLS)
def test_workload_file(cell):
    spec = next(w for w in SPEC["workloads"] if w["name"] == cell)
    w = load("workloads", cell + ".json")
    for k in ("config", "traffic", "chips", "why"):
        assert w[k] == spec[k]
    entry = importlib.import_module(f"entries.{w['entry']}")
    traffic = load("traffic", w["traffic"] + ".json")
    assert traffic["name"] == w["traffic"]
    assert os.path.exists(os.path.join(BENCH, "traffic",
                                       traffic["generator"] + ".py"))
    assert set(w["limits"]) == set(entry.NUMBERS)
