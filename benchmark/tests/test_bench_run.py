"""run.py's harness at the tiny size on the CPU: the look for a card is
skipped by calling `execute` in-process, the rest of a run is driven as on
the card. The result is well formed; each fault of the cell, planted in the
program underneath the timed path, and the control (the reference in fp8
in the program's place) make `correct` false; from the command line, with
no card, no result is printed; the no-JAX check compares whole top-level
names."""

import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import HERE, ROOT

import run
from entries import i2v

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
SEED = 2 ** 31 + 4242


def tiny_cell(trace=False, name="dc512.i2v"):
    cfg = json.load(open(os.path.join(HERE, "tiny.json")))
    wl = json.load(open(os.path.join(run.HERE, "workloads", name + ".json")))
    wl["trace_steps"] = [1, 2]
    return run.Cell(name, SEED, 0.5, trace, torch.device("cpu"),
                    workload=wl, config=cfg)


@pytest.mark.parametrize("trace", [False, True])
def test_result_is_well_formed(trace):
    cell = tiny_cell(trace)
    result, record = run.execute(cell, SPEC)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["attempted"] >= 1
    names = ({m["name"] for m in SPEC["per_layer"]} if trace
             else {m["name"] for m in SPEC["end_to_end"]})
    assert set(result["metrics"]) <= names
    if not trace:
        assert set(result["metrics"]) == {"setup_s", "clip_s"}
    for m in result["metrics"].values():
        assert isinstance(m["value"], float) and m["value"] > 0
    for n in result["checks"].values():
        assert set(n) == {"value", "limit"}
    # a CPU run names its platform: never a device metric under "gpu"
    assert result["device"]["platform"] == "cpu"
    json.dumps(result)


@pytest.mark.parametrize("fault", sorted(i2v.FAULTS))
def test_each_fault_makes_correct_false(fault):
    with i2v.FAULTS[fault]():
        result, _ = run.execute(tiny_cell(), SPEC)
    assert result["correct"] is False


def test_control_fails_the_limits():
    cell = tiny_cell()
    keep, steps = i2v.one_clip(cell)
    out = i2v.check(cell, keep, steps, control=True)
    assert all(n["value"] <= n["limit"] for n in out["program"].values())
    assert any(n["value"] > n["limit"] for n in out["control"].values())


@pytest.mark.card
def test_control_at_the_cells_size(card):
    """The control on the card at each i2v cell's own size, one seed: it
    fails the cell's limits where the program passes them."""
    for name in ("dc512.i2v", "dc1024.i2v"):
        cell = run.Cell(name, SEED, 0.0, False, card)
        keep, steps = i2v.one_clip(cell)
        out = i2v.check(cell, keep, steps, control=True)
        assert all(n["value"] <= n["limit"] for n in out["program"].values())
        assert any(n["value"] > n["limit"] for n in out["control"].values())


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "dc512.i2v",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0",
         "--out", os.path.join(HERE, "..", "..", "bench_out", "test")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert not p.stdout.strip()


def test_no_jax_check_compares_whole_names():
    assert run.forbidden_modules(
        ["jax.numpy", "jaxlib", "flax.linen", "open_pandora_tpu.models.vae",
         "open_pandora_tpu"]) == ["flax", "jax", "jaxlib", "open_pandora_tpu"]
    assert run.forbidden_modules(
        ["open_pandora_tpu_torch", "open_pandora_tpu_torch.models.vae",
         "jaxtyping", "torch"]) == []


def test_benchmark_loads_no_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['open_pandora_tpu'] = None; "
            "sys.path[:0] = ['benchmark', '.']; "
            "import run, flops, weights, trace, calibrate; "
            "from entries import i2v; i2v.Program; "
            "import open_pandora_tpu_torch.eval.inference; "
            "print(run.forbidden_modules([m for m in sys.modules "
            "if sys.modules[m] is not None]))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().endswith("[]")
