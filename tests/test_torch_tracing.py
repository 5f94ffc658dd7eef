"""PyTorch port, the spans and shape counts of utils/profiling.py: recorded
only under a torch.profiler profile, nested with their parent and request
id, on the trace's own clock; the spans of a DDIM-2 `synthesize` on the
debug configuration (one `ddim.step` with its three children and one `unet`
a step, one block span per UNet block), whose frames equal those of an
unprofiled call; the kernel wrappers' counts beside their `.launches`. The
`card` case runs the three kernels under a CUDA-only profile on the card:
`python3 -m pytest -p no:cacheprovider --noconftest -m card
tests/test_torch_tracing.py`. This file imports no JAX."""

import contextlib
import importlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from open_pandora_tpu_torch.eval.inference import (build_model, debug_config,
                                                   synthesize)
from open_pandora_tpu_torch.models.unet3d import (ResBlock,
                                                  SpatialTransformer,
                                                  TemporalTransformer)
from open_pandora_tpu_torch.ops import kernels
from open_pandora_tpu_torch.utils import profiling

tpa = importlib.import_module("open_pandora_tpu_torch.ops.packed_attention")
tfn = importlib.import_module("open_pandora_tpu_torch.ops.fused_norms")
tft = importlib.import_module("open_pandora_tpu_torch.ops.fused_temporal")
tfg = importlib.import_module("open_pandora_tpu_torch.ops.fused_geglu")
BF16 = torch.bfloat16


@pytest.fixture(autouse=True)
def _fresh():
    profiling.clear()
    yield
    profiling.clear()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def by_name(spans, name):
    return [i for i, s in enumerate(spans) if s["name"] == name]


def children(spans, i):
    return [s["name"] for s in spans if s["parent"] == i]


def event_ns(prof, e) -> tuple:
    """An event's [start, end] in CLOCK_REALTIME nanoseconds: the trace's
    start plus the event's offset (time_range, in microseconds)."""
    t0 = prof.profiler.kineto_results.trace_start_ns()
    return (t0 + round(e.time_range.start * 1e3),
            t0 + round(e.time_range.end * 1e3))


def assert_on_span_clock(prof, spans):
    """Each recorded span's record_function event lies inside the span."""
    events = {}
    for e in prof.events():
        if e.is_user_annotation:
            events.setdefault(e.name, []).append(event_ns(prof, e))
    for s in spans:
        evs = events[s["name"]]
        assert any(s["start_ns"] <= a <= b <= s["end_ns"] for a, b in evs), s


def test_off_records_nothing():
    assert not profiling.recording()
    ctx = profiling.span("unet", index=3)
    assert ctx is profiling.NULL_SPAN
    with ctx as got:
        assert got is None
    with profiling.clip() as cid:
        with profiling.span("ddim.step"):
            profiling.count("packed_attention", (1, 2))
    assert cid >= 1
    assert profiling.spans() == [] and profiling.counts() == {}


def test_spans_nest_carry_clip_and_share_the_trace_clock():
    with cpu_profile() as prof:
        with profiling.clip() as cid:
            with profiling.span("ddim.step", index=7):
                with profiling.span("ddim.eval"):
                    torch.ones(64).sum()
                with profiling.span("ddim.update"):
                    torch.ones(64).mul(2)
        with profiling.span("outside"):
            pass
    spans = profiling.spans()
    assert [s["name"] for s in spans] == ["clip", "ddim.step", "ddim.eval",
                                          "ddim.update", "outside"]
    assert [s["parent"] for s in spans] == [None, 0, 1, 1, None]
    assert [s["clip"] for s in spans] == [cid] * 4 + [None]
    assert spans[1]["attrs"] == {"index": 7}
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
    assert spans[0]["start_ns"] <= spans[1]["start_ns"] <= \
        spans[2]["start_ns"] <= spans[2]["end_ns"] <= spans[3]["start_ns"]
    assert_on_span_clock(prof, spans)


def test_clip_id_without_its_span_and_a_stop_inside_a_span():
    """The profiler starts inside a request and stops inside a span, as the
    benchmark's slice does: the spans recorded carry the request's id, the
    span open at the stop keeps its end, and none after is recorded."""
    prof = cpu_profile()
    with profiling.clip() as cid:
        with profiling.span("ddim.step"):       # before the profiler
            prof.start()
        with profiling.span("ddim.step"):
            with profiling.span("ddim.eval"):
                prof.stop()
                with profiling.span("unet"):
                    pass
    spans = profiling.spans()
    assert [s["name"] for s in spans] == ["ddim.step", "ddim.eval"]
    assert [s["clip"] for s in spans] == [cid, cid]
    assert spans[1]["parent"] == 0
    assert all(s["end_ns"] >= s["start_ns"] for s in spans)
    assert profiling.RECORDER.open == []


def test_synthesize_spans_and_unchanged_frames():
    cfg = debug_config()
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    image = np.random.default_rng(0).integers(0, 256, (40, 48, 3),
                                              dtype=np.uint8)

    def run():
        return synthesize(model, image, "a boat on a lake", height=32,
                          width=32, ddim_steps=2,
                          generator=torch.Generator().manual_seed(5))
    plain = run()
    assert profiling.spans() == []
    with cpu_profile() as prof:
        traced = run()
    assert np.array_equal(plain, traced)
    spans = profiling.spans()
    (clip,) = by_name(spans, "clip")
    cid = spans[clip]["clip"]
    assert all(s["clip"] == cid for s in spans)
    assert children(spans, clip) == ["conditioning", "sampling", "decode"]
    (sampling,) = by_name(spans, "sampling")
    steps = by_name(spans, "ddim.step")
    assert [spans[i]["parent"] for i in steps] == [sampling] * 2
    assert [spans[i]["attrs"]["index"] for i in steps] == [0, 1]
    unet_mod = model.model.diffusion_model
    want = {name: sum(isinstance(m, kind) for m in unet_mod.modules())
            for name, kind in (("unet.resblock", ResBlock),
                               ("unet.spatial", SpatialTransformer),
                               ("unet.temporal", TemporalTransformer))}
    assert all(want.values())
    for i in steps:
        assert children(spans, i) == ["ddim.eval", "ddim.guidance",
                                      "ddim.update"]
        (ev,) = [j for j, s in enumerate(spans)
                 if s["parent"] == i and s["name"] == "ddim.eval"]
        (unet,) = [j for j, s in enumerate(spans) if s["parent"] == ev]
        assert spans[unet]["name"] == "unet"
        inside = children(spans, unet)
        assert {n: inside.count(n) for n in want} == want
        assert len(inside) == sum(want.values())
    assert len(by_name(spans, "unet")) == 2
    assert_on_span_clock(prof, spans)


def test_counter_registry():
    profiling.count("group_norm_silu", ((2, 8, 64), 32, "bfloat16"))
    assert profiling.counts() == {}
    with cpu_profile():
        for key in ((1, 2), (1, 2), (3, 4)):
            profiling.count("packed_attention", key)
        profiling.count("group_norm_silu", ((2, 8, 64), 32, "bfloat16"))
    assert profiling.counts() == {
        "packed_attention": {(1, 2): 2, (3, 4): 1},
        "group_norm_silu": {((2, 8, 64), 32, "bfloat16"): 1}}
    got = profiling.counts()
    got["packed_attention"][(1, 2)] = 99       # a copy: the registry stays
    assert profiling.counts()["packed_attention"][(1, 2)] == 2


class _FakeLibrary:
    """Every C entry point returns 0 (success) and launches nothing."""

    def __getattr__(self, name):
        return lambda *args: 0


def _cpu_launchers(monkeypatch):
    monkeypatch.setattr(kernels, "library", lambda: _FakeLibrary())
    monkeypatch.setattr(kernels, "check_cuda_tensors", lambda *a: None)
    monkeypatch.setattr(kernels, "stream_handle", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())


def _temporal_inputs(shape, gen, device):
    c = shape[-1]
    ws = [torch.randn(c, c, generator=gen).to(device, BF16)
          for _ in range(4)]
    vs = [torch.randn(c, generator=gen).to(device, BF16) for _ in range(3)]
    return torch.randn(*shape, generator=gen).to(device, BF16), ws + vs


def run_wrappers(launch, device):
    """Each wrapper's launcher at two or three shapes, under the profiler;
    returns the counts and the `.launches` deltas."""
    gen = torch.Generator().manual_seed(0)

    def rnd(*s):
        return torch.randn(*s, generator=gen).to(device, BF16)
    before = (tpa.packed_attention.launches
              + tpa.packed_attention_multi.launches,
              tfn.fused_group_norm_silu.launches,
              tft.fused_temporal_self_attention.launches)
    # edge cases of chip_smoke's phase 3 for each kernel
    q = rnd(2, 1000, 256)
    kv = [(rnd(2, m, 256), rnd(2, m, 256)) for m in (300, 100, 130)]
    x1, x2 = rnd(1, 40, 64, 320), rnd(3, 1000, 96)
    w320, w96 = rnd(320), rnd(96)
    y, p = _temporal_inputs((2, 16, 37, 320), gen, device)
    launch["packed"](q, kv[:1], 1.0, heads=2)
    launch["packed"](q, kv[1:], 0.25, heads=2)
    launch["packed"](q, kv[:1], 1.0, heads=2)
    launch["gn"](x1, w320, w320, num_groups=32, eps=1e-5, silu=True)
    launch["gn"](x2, w96, w96, num_groups=32, eps=1e-5, silu=True)
    launch["temporal"](y, *p, heads=5, eps=1e-5)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    after = (tpa.packed_attention.launches
             + tpa.packed_attention_multi.launches,
             tfn.fused_group_norm_silu.launches,
             tft.fused_temporal_self_attention.launches)
    deltas = dict(zip(("packed_attention", "group_norm_silu",
                       "fused_temporal"),
                      (a - b for a, b in zip(after, before))))
    return deltas


LAUNCHERS = {"packed": tpa._packed_cuda, "gn": tfn._gn_cuda,
             "temporal": tft._fused_temporal_cuda}
WANT = {"packed_attention": {(2, 1000, 2, 128, (300,), "bfloat16"): 2,
                             (2, 1000, 2, 128, (100, 130), "bfloat16"): 1},
        "group_norm_silu": {((1, 40, 64, 320), 32, "bfloat16"): 1,
                            ((3, 1000, 96), 32, "bfloat16"): 1},
        "fused_temporal": {(2, 16, 37, 320, 5, "bfloat16"): 1}}


def test_wrappers_count_beside_their_launches(monkeypatch):
    """The count sites of the three wrappers, reached on the CPU through a
    library whose entry points do nothing."""
    _cpu_launchers(monkeypatch)
    cpu = torch.device("cpu")
    run_wrappers(LAUNCHERS, cpu)
    assert profiling.counts() == {}
    with cpu_profile():
        deltas = run_wrappers(LAUNCHERS, cpu)
    assert profiling.counts() == WANT
    assert deltas == {op: sum(keys.values()) for op, keys in WANT.items()}


def test_geglu_wrapper_counts_one_call(monkeypatch):
    """The fused GEGLU wrapper's count site, reached on the CPU through a
    library whose entry points do nothing: one recorded call counts once
    under (rows, c, inner, dtype), beside its `.launches`; unrecorded
    calls count nothing."""
    _cpu_launchers(monkeypatch)
    monkeypatch.setattr(kernels, "multiprocessors", lambda device: 132)
    gen = torch.Generator().manual_seed(0)

    def rnd(*s):
        return torch.randn(*s, generator=gen).to(BF16)
    c, inner = 64, 256
    args = (rnd(3, 100, c), rnd(c), rnd(c), rnd(c, 2 * inner),
            rnd(2 * inner), rnd(inner, c), rnd(c))
    flat = (args[0].reshape(-1, c), *args[1:])
    tfg._geglu_cuda(*flat, 1e-5)
    assert profiling.counts() == {}
    before = tfg.fused_geglu_ff.launches
    with cpu_profile():
        tfg._geglu_cuda(*flat, 1e-5)
    assert profiling.counts() == {
        "fused_geglu": {(300, c, inner, "bfloat16"): 1}}
    assert tfg.fused_geglu_ff.launches == before + 1


@pytest.mark.parametrize("op", ["small_attention", "flash_attention"])
def test_attention_wrappers_count_one_call(monkeypatch, op):
    """The small-attention and flash wrappers' count sites (the SVD-XT
    cell's temporal self-attention and VAE attention), reached on the CPU
    through a library whose entry points do nothing: one recorded call
    counts once under (batch, n, m, heads, d[, causal], dtype), beside its
    `.launches`; unrecorded calls count nothing."""
    mod = importlib.import_module(f"open_pandora_tpu_torch.ops.{op}")
    _cpu_launchers(monkeypatch)
    monkeypatch.setattr(kernels, "check_qkv", lambda *a: None)
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(6, n, 2, 64, generator=gen).to(BF16)
               for n in (25, 25, 25))
    if op == "small_attention":
        def call():
            return mod._small_cuda(q, k, v, sm_scale=0.125)
        key = (6, 25, 25, 2, 64, "bfloat16")
    else:
        def call():
            return mod._flash_cuda(q, k, v, causal=False, sm_scale=None)
        key = (6, 25, 25, 2, 64, False, "bfloat16")
    call()
    assert profiling.counts() == {}
    before = getattr(mod, op).launches
    with cpu_profile():
        call()
    assert profiling.counts() == {op: {key: 1}}
    assert getattr(mod, op).launches == before + 1


@pytest.mark.card
def test_card_cuda_only_profile_records(card):
    """Under the benchmark's kind of profile (CUDA activity alone) the flag
    is on, spans and counts are recorded, each op's counted calls equal its
    `.launches` delta and its kernels are in the trace (two a call for
    GroupNorm+SiLU); under CPU + CUDA the spans sit on the trace's clock."""
    from torch.autograd import DeviceType

    kernels.library()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        assert profiling.recording()
        with profiling.span("unet"):
            deltas = run_wrappers(LAUNCHERS, card)
    assert [s["name"] for s in profiling.spans()] == ["unet"]
    counted = {op: sum(keys.values())
               for op, keys in profiling.counts().items()}
    assert counted == deltas == {op: sum(k.values())
                                 for op, k in WANT.items()}
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    assert sum("packed_attn_kernel" in n for n in names) == 3
    assert sum("gn_stats_kernel" in n or "gn_apply_kernel" in n
               for n in names) == 2 * 2
    assert sum("fused_temporal" in n for n in names) == 1
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with profiling.span("ddim.step"):
            with profiling.span("unet"):
                run_wrappers(LAUNCHERS, card)
    assert_on_span_clock(prof, profiling.spans())
