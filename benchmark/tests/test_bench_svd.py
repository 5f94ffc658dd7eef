"""The SVD-XT cell (entries/svd_i2v.py, reference/svd.py, flops_svd.py and
its metric readers) on the CPU at a tiny size: the result is well formed;
each fault planted under the timed path, and the control (the reference in
fp8 in the program's place), make `correct` false; the frozen count is
positive and stable; every new reader returns a number on a traced record;
BENCHMARK.json's new entries load; the benchmark's reference agrees with
the CPU tests' copy."""

import dataclasses
import importlib.util
import json
import os
import runpy
import sys
import types

import pytest
import torch

from conftest import BENCH, HERE, ROOT

import flops_svd
import run
from entries import svd_i2v
from reference import svd as ref

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
SEED = 2 ** 31 + 4242
CELL = "svdxt.i2v"
PROFILING = "open_pandora_tpu_torch.utils.profiling"


def tiny_config():
    return json.load(open(os.path.join(HERE, "tiny_svd.json")))


def tiny_cell(trace=False):
    wl = json.load(open(os.path.join(BENCH, "workloads", CELL + ".json")))
    wl["trace_steps"] = [1, 1]
    return run.Cell(CELL, SEED, 0.5, trace, torch.device("cpu"),
                    workload=wl, config=tiny_config())


def metric(name):
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("trace", [False, True])
def test_result_is_well_formed(trace):
    result, record = run.execute(tiny_cell(trace), SPEC)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert result["correct"] is True and result["attempted"] >= 1
    assert set(result["checks"]) == set(svd_i2v.NUMBERS)
    if not trace:
        assert set(result["metrics"]) == {"setup_s", "clip_s.hires"}
    else:
        assert {"cond_s.svdxt", "edm_step_ms.svdxt", "decode_s.svdxt",
                "mfu.svdxt"} <= set(result["metrics"])
    assert record["kind"] == "i2v"
    json.dumps(result)


@pytest.mark.parametrize("fault", sorted(svd_i2v.FAULTS))
def test_each_fault_makes_correct_false(fault):
    with svd_i2v.FAULTS[fault]():
        result, _ = run.execute(tiny_cell(), SPEC)
    assert result["correct"] is False


def test_control_fails_the_limits():
    cell = tiny_cell()
    keep, steps = svd_i2v.one_clip(cell)
    out = svd_i2v.check(cell, keep, steps, control=True)
    assert all(n["value"] <= n["limit"] for n in out["program"].values())
    assert any(n["value"] > n["limit"] for n in out["control"].values())


@pytest.mark.card
def test_control_at_the_cells_size(card):
    cell = run.Cell(CELL, SEED, 0.0, False, card)
    keep, steps = svd_i2v.one_clip(cell)
    out = svd_i2v.check(cell, keep, steps, control=True)
    assert all(n["value"] <= n["limit"] for n in out["program"].values())
    assert any(n["value"] > n["limit"] for n in out["control"].values())


def test_flop_count_positive_and_stable():
    tiny = flops_svd.svd_parts(tiny_config())
    assert tiny == flops_svd.svd_parts(tiny_config())
    assert all(v > 0 for v in tiny.values())
    full = json.load(open(os.path.join(BENCH, "configs", "svd_xt.json")))
    parts = flops_svd.svd_parts(full)
    # frozen: the reference's products of one batched-CFG eval at
    # 576x1024x25, of the 25-frame decode and of the conditioning
    assert parts == {"conditioning": 2943708594176,
                     "cfg_eval": 159896908759040,
                     "decode": 173574202982400}


def test_new_readers_return_numbers(monkeypatch):
    monkeypatch.setitem(sys.modules, PROFILING, types.SimpleNamespace(
        spans=lambda: [], counts=lambda: {
            "fused_geglu": {(460800, 320, 1280, "bfloat16"): 15},
            "packed_attention": {(50, 9216, 5, 64, (9216,), "bfloat16"): 5},
            "small_attention": {(18432, 25, 25, 5, 64, "bfloat16"): 5},
            "group_norm_silu": {((50, 9216, 320), 32, "bfloat16"): 40}}))
    item = {"wall_s": 20.0, "steps": 30, "profiled": False,
            "timings": {"conditioning_s": 0.2, "sampling_s": 18.0,
                        "decode_s": 1.5}}
    record = {"kind": "i2v", "items": [item, dict(item, profiled=True)],
              "flops_per_item": 5e15, "peak_flops": 989e12,
              "trace": {"launches": 5000, "steps": 5, "busy_s": 2.5,
                        "window_s": 3.1, "profiler_idle_s": 0.0,
                        "by_class_s": {"fused_geglu": 0.2,
                                       "packed_attn_fwd": 0.5,
                                       "small_attn_fwd": 0.1,
                                       "group_norm_silu": 0.3}}}
    new = [m["name"] for m in SPEC["per_layer"]
           if m.get("workloads") == [CELL]]
    assert len(new) == 12
    for name in new:
        v = metric(name)(record)
        assert isinstance(v, float) and v > 0, name


@pytest.mark.parametrize("key,ms", [
    ((1152, 16, 16, 20, 64, "bfloat16"), 0.0563),
    ((288, 16, 16, 20, 64, "bfloat16"), 0.0141),
    ((5120, 16, 16, 5, 64, "bfloat16"), 0.0626),
])
def test_small_attn_bound_matches_phase_3(key, ms):
    bound_s = runpy.run_path(os.path.join(
        BENCH, "metrics", "small_attn_roofline.svdxt.py"))["bound_s"]
    assert bound_s(*key) * 1e3 == pytest.approx(ms, abs=0.5e-4)


def test_benchmark_entries():
    cfgs = {c["name"]: c for c in SPEC["configs"]}
    assert cfgs["svd_xt"]["reduced"] == []
    assert cfgs["svd_xt"]["file"] == "benchmark/configs/svd_xt.json"
    cells = {w["name"]: w for w in SPEC["workloads"]}
    assert cells[CELL]["chips"] == 1 and cells[CELL]["config"] == "svd_xt"
    hires = [m for m in SPEC["end_to_end"] if m["name"] == "clip_s.hires"]
    assert hires[0]["workloads"] == ["dc1024.i2v", CELL]
    assert hires[0]["bound"] == 0.014
    conf = json.load(open(os.path.join(BENCH, "configs", "svd_xt.json")))
    assert conf["source"] == cfgs["svd_xt"]["source"]
    assert conf["reduced"] == [] and conf["assumed"]
    sys.path.insert(0, ROOT)
    from open_pandora_tpu_torch.core.config import SVDConfig
    port = svd_i2v.port_config(conf)
    assert port == SVDConfig()
    for m in SPEC["per_layer"]:
        if CELL in m.get("workloads", ()):
            assert os.path.exists(os.path.join(BENCH, "metrics",
                                               m["name"] + ".py"))


def test_benchmark_reference_agrees_with_the_tests_copy():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import svd_reference as tref
    cfg = tiny_config()
    with torch.device("meta"):
        a, b = ref.SVD(cfg), tref.SVD(cfg)
    a, b = a.to_empty(device="cpu"), b.to_empty(device="cpu")
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    assert set(pa) == set(pb)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for k in sorted(pa):
            pa[k].copy_(torch.randn(pa[k].shape, generator=g) * 0.2)
            pb[k].copy_(pa[k])
    img = torch.rand(1, 32, 48, 3, generator=g)
    x = torch.randn(2, 5, 16, 24, 4, generator=g)
    with torch.no_grad():
        ca, cb = a.conditioning(img, img * 2 - 1), b.conditioning(img,
                                                                 img * 2 - 1)
        assert torch.equal(a.denoise(x, torch.tensor(2.0), ca),
                           b.denoise(x, torch.tensor(2.0), cb))
        assert torch.equal(a.decode(x[:1]), b.decode(x[:1]))
    assert dataclasses.is_dataclass(type(svd_i2v.port_config(cfg)))
