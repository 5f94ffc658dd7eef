"""The reduction of a profiled slice (trace.py), the idle readers that use
it, and the traffic loader, which finds a mix's generator by the name its
data file gives."""

import json
import os
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from conftest import BENCH, HERE

import trace
from traffic import generator


def event(start, end, name, device=DeviceType.CUDA):
    return SimpleNamespace(time_range=SimpleNamespace(start=start, end=end),
                           device_type=device, name=name,
                           is_user_annotation=False)


def fake_profile():
    """Two device operations with a gap of 40 us, 30 of it in the
    profiler's buffer request; the slice runs from 0 to 100 us."""
    cpu = DeviceType.CPU
    return SimpleNamespace(events=lambda: [
        event(0, 5, "cudaLaunchKernel", cpu),
        event(10, 30, "gemm_kernel"),
        event(40, 70, "Activity Buffer Request", cpu),
        event(70, 90, "copy_kernel"),
        event(95, 100, "cudaDeviceSynchronize", cpu),
    ])


def test_overlap_of_interval_lists():
    assert trace.overlap([[0, 10], [20, 30]], [[5, 25]]) == 10
    assert trace.overlap([[0, 10]], [[10, 20]]) == 0
    assert trace.overlap([], [[0, 1]]) == 0


def test_reduce_takes_the_profilers_own_idle_out():
    tr = trace.reduce(fake_profile())
    assert tr["launches"] == 2
    assert tr["window_s"] == pytest.approx(100e-6)
    assert tr["busy_s"] == pytest.approx(40e-6)
    assert tr["profiler_idle_s"] == pytest.approx(30e-6)
    assert tr["idle_gaps"][0][0].startswith("Activity Buffer Request")


def read(name, record):
    import run
    return run.read_metric(name, record)


def test_idle_readers():
    tr = dict(trace.reduce(fake_profile()), steps=1)
    items = [{"profiled": False, "steps": 2,
              "timings": {"sampling_s": 160e-6}},
             {"profiled": True, "steps": 2,
              "timings": {"sampling_s": 1.0}}]
    record = {"kind": "i2v", "trace": tr, "items": items}
    # 40 busy of 100 - 30 in the slice; 40 busy a step of 80 untraced
    assert read("idle_share.i2v", record) == pytest.approx(100 * 30 / 70)
    assert read("idle_untraced.i2v", record) == pytest.approx(50.0)
    assert read("idle_untraced.hires", record) == pytest.approx(50.0)
    assert read("device_step_ms.i2v", record) == pytest.approx(0.04)
    assert read("device_step_ms.hires", record) == pytest.approx(0.04)


def test_traffic_file_names_its_generator(tmp_path, monkeypatch):
    cfg = json.load(open(os.path.join(HERE, "tiny.json")))
    params = generator.load("i2v_one_client")
    a = generator.make("i2v_one_client", cfg, 2 ** 31 + 7,
                       torch.device("cpu"))
    # a new mix is a data file naming its generator module
    (tmp_path / "other_mix.json").write_text(json.dumps(dict(
        params, name="other_mix", prompt_words=[3, 3])))
    monkeypatch.setattr(generator, "HERE", str(tmp_path))
    b = generator.make("other_mix", cfg, 2 ** 31 + 7, torch.device("cpu"))
    assert type(a).__module__ == type(b).__module__ == "traffic.i2v_images"
    assert len(b.request(0)["prompt"].split()) == 3
    assert torch.equal(a.request(5)["image"], b.request(5)["image"])


def test_every_traffic_file_has_its_generator():
    d = os.path.join(BENCH, "traffic")
    for f in sorted(os.listdir(d)):
        if f.endswith(".json"):
            params = json.load(open(os.path.join(d, f)))
            assert params["name"] + ".json" == f
            assert os.path.exists(os.path.join(d, params["generator"]
                                               + ".py"))
