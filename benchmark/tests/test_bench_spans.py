"""The readers of the program's own spans and shape counts
(program_spans.py, the host-time and roofline metrics) on a synthetic
record, and the frozen bound arithmetic (rooflines.py) against the bound
column of chip_smoke's phase 3 as PERF.md quotes it."""

import importlib.util
import os
import sys
import types

import pytest

from conftest import BENCH

import program_spans
import rooflines

PROFILING = "open_pandora_tpu_torch.utils.profiling"


def metric(name):
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def span(name, start_ms, end_ms, parent=None):
    return {"name": name, "start_ns": int(start_ms * 1e6),
            "end_ns": None if end_ms is None else int(end_ms * 1e6),
            "parent": parent, "clip": 2, "attrs": {}}


# two evals: a unet span each, ResBlocks 3 + 5 ms, spatial 4 ms, temporal
# 2 + 2 ms; two updates (1 ms each) and one guidance (0.5 ms); a last
# ddim.eval still open when the slice ended
SPANS = [span("ddim.guidance", 0, 0.5), span("ddim.update", 0.5, 1.5),
         span("ddim.step", 2, 20), span("ddim.eval", 2, 15, 2),
         span("unet", 2, 15, 3), span("unet.resblock", 2, 5, 4),
         span("unet.spatial", 5, 9, 4), span("unet.temporal", 9, 11, 4),
         span("ddim.update", 19, 20, 2), span("ddim.step", 21, None),
         span("ddim.eval", 21, None, 9), span("unet", 21, 35, 10),
         span("unet.resblock", 21, 26, 11), span("unet.temporal", 26, 28, 11)]
PACKED = (32, 2560, 5, 64, (2560,), "bfloat16")
COUNTS = {"packed_attention": {PACKED: 10},
          "group_norm_silu": {((32, 40, 64, 320), 32, "bfloat16"): 4},
          "fused_temporal": {(2, 16, 2560, 320, 5, "bfloat16"): 2}}


def record(by_class=None):
    return {"kind": "i2v", "items": [], "trace": {
        "launches": 100, "steps": 5,
        "by_class_s": by_class or {"packed_attn_fwd": 0.01,
                                   "group_norm_silu": 0.0005,
                                   "fused_temporal_attn": 0.0005}}}


@pytest.fixture
def program(monkeypatch):
    mod = types.SimpleNamespace(spans=lambda: SPANS, counts=lambda: COUNTS)
    monkeypatch.setitem(sys.modules, PROFILING, mod)
    return mod


def test_host_metrics(program):
    r = record()
    assert metric("resblock_host_ms.i2v")(r) == pytest.approx(4.0)
    assert metric("spatial_host_ms.i2v")(r) == pytest.approx(2.0)
    assert metric("temporal_host_ms.i2v")(r) == pytest.approx(2.0)
    assert metric("sampler_host_ms.i2v")(r) == pytest.approx(1.25)


@pytest.mark.parametrize("cell", ["i2v", "hires"])
def test_roofline_shares(program, cell):
    r = record()
    packed = 10 * rooflines.packed_attention(*PACKED)
    assert metric(f"packed_attn_roofline.{cell}")(r) == \
        pytest.approx(100 * packed / 0.01)
    assert metric(f"gn_silu_roofline.{cell}")(r) == \
        pytest.approx(100 * 4 * 0.0313e-3 / 0.0005, rel=1e-3)
    assert metric(f"temporal_attn_roofline.{cell}")(r) == \
        pytest.approx(100 * 2 * 0.0696e-3 / 0.0005, rel=1e-3)


NAMES = ["resblock_host_ms.i2v", "spatial_host_ms.i2v", "temporal_host_ms.i2v",
         "sampler_host_ms.i2v", "packed_attn_roofline.i2v",
         "packed_attn_roofline.hires", "gn_silu_roofline.i2v",
         "gn_silu_roofline.hires", "temporal_attn_roofline.i2v",
         "temporal_attn_roofline.hires"]


@pytest.mark.parametrize("name", NAMES)
def test_none_when_nothing_was_recorded(monkeypatch, name):
    read = metric(name)
    # a program without the recorder (the module absent, or one without
    # spans and counts, as before the program recorded anything)
    monkeypatch.setitem(sys.modules, PROFILING, None)
    assert read(record()) is None
    monkeypatch.setitem(sys.modules, PROFILING, types.SimpleNamespace())
    assert read(record()) is None
    # a recorder that recorded nothing, or a record with no profiled slice
    monkeypatch.setitem(sys.modules, PROFILING, types.SimpleNamespace(
        spans=lambda: [], counts=lambda: {}))
    assert read(record()) is None
    monkeypatch.setitem(sys.modules, PROFILING, types.SimpleNamespace(
        spans=lambda: SPANS, counts=lambda: COUNTS))
    assert read({"kind": "i2v", "items": []}) is None
    assert read({"kind": "i2v", "items": [], "trace": {"launches": 0}}) \
        is None


def test_a_class_with_no_device_time_reads_none(program):
    assert program_spans.roofline(record({"gemm": 1.0}),
                                  "packed_attention") is None


@pytest.mark.parametrize("fn,key,ms", [
    (rooflines.packed_attention, (32, 2560, 5, 64, (2560,), "bfloat16"),
     0.271),
    (rooflines.packed_attention, (32, 9216, 5, 64, (9216,), "bfloat16"),
     3.518),
    (rooflines.group_norm_silu, ((32, 40, 64, 320), 32, "bfloat16"), 0.0313),
    (rooflines.group_norm_silu, ((32, 72, 128, 320), 32, "bfloat16"),
     0.1127),
    (rooflines.fused_temporal, (2, 16, 2560, 320, 5, "bfloat16"), 0.0696),
    (rooflines.fused_temporal, (2, 16, 9216, 320, 5, "bfloat16"), 0.2504),
])
def test_bounds_match_phase_3(fn, key, ms):
    """To the digits PERF.md quotes."""
    digits = len(repr(ms).split(".")[1])
    assert fn(*key) * 1e3 == pytest.approx(ms, abs=0.5 * 10 ** -digits)
