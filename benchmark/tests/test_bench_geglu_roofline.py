"""The fused GEGLU feed-forward's roofline share (metrics/geglu_roofline.*):
its frozen bound against the bound column of chip_smoke's phase 3 as
PERF.md quotes it, the share on a synthetic record, and None where the
program records nothing."""

import importlib.util
import os
import runpy
import sys
import types

import pytest

from conftest import BENCH

PROFILING = "open_pandora_tpu_torch.utils.profiling"
PATH = os.path.join(BENCH, "metrics", "geglu_roofline.i2v.py")
bound_s = runpy.run_path(PATH)["bound_s"]
CALLS = {(81920, 320, 1280, "bfloat16"): 4, (5120, 1280, 5120, "bfloat16"): 2}


def metric(name):
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def record(busy=0.004):
    return {"kind": "i2v", "items": [], "trace": {
        "launches": 100, "steps": 5, "by_class_s": {"fused_geglu": busy}}}


@pytest.mark.parametrize("key,ms", [
    ((81920, 320, 1280, "bfloat16"), 0.2036),
    ((294912, 320, 1280, "bfloat16"), 0.7328),
    ((20480, 640, 2560, "bfloat16"), 0.2036),
    ((5120, 1280, 5120, "bfloat16"), 0.2036),
])
def test_bound_matches_phase_3(key, ms):
    """To the digits PERF.md quotes."""
    assert bound_s(*key) * 1e3 == pytest.approx(ms, abs=0.5e-4)


@pytest.mark.parametrize("cell", ["i2v", "hires"])
def test_share(monkeypatch, cell):
    monkeypatch.setitem(sys.modules, PROFILING, types.SimpleNamespace(
        spans=lambda: [], counts=lambda: {"fused_geglu": CALLS}))
    want = 100 * (4 * bound_s(81920, 320, 1280, "bfloat16")
                  + 2 * bound_s(5120, 1280, 5120, "bfloat16")) / 0.004
    assert metric(f"geglu_roofline.{cell}")(record()) == pytest.approx(want)


@pytest.mark.parametrize("cell", ["i2v", "hires"])
def test_none_when_nothing_was_recorded(monkeypatch, cell):
    read = metric(f"geglu_roofline.{cell}")
    # the parent program: a recorder that counts other ops but not this one
    monkeypatch.setitem(sys.modules, PROFILING, types.SimpleNamespace(
        spans=lambda: [], counts=lambda: {"fused_temporal": {(1,): 1}}))
    assert read(record()) is None
    monkeypatch.setitem(sys.modules, PROFILING, None)
    assert read(record()) is None
    monkeypatch.setitem(sys.modules, PROFILING, types.SimpleNamespace(
        spans=lambda: [], counts=lambda: {"fused_geglu": CALLS}))
    assert read(record(busy=0.0)) is None
    assert read({"kind": "i2v", "items": []}) is None
