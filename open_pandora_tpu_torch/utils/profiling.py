"""Tracing, timing and device-memory readings.

Counterpart of open_pandora_tpu/utils/profiling.py (the reference's
CUDACallback epoch time and peak memory, utils/callbacks.py:104-133):

  - trace(logdir): torch.profiler over the CPU and, where present, CUDA,
    written to `logdir` as a TensorBoard / Chrome trace
  - span(name, **attrs): a named region of the program, recorded while a
    torch.profiler profile runs (any profile: `trace`, a CUDA-only one, the
    operator's own); count(op, key): a call of a kernel wrapper, keyed on
    the shapes and dtype that set its work; clip(): one request, whose id
    every span recorded inside it carries; spans(), counts() and clear()
    for readers
  - sync(x): torch.cuda.synchronize on the device of x's first tensor
  - device_memory_stats(): per-CUDA-device bytes in use, peak and limit
  - count_params: elements over a module, a state dict or a dict of arrays

Spans and counts are recorded only while the profiler's own on-flag is set
(`recording()`): no switch of their own. Off, `span` is one flag check that
returns a shared null context. On, a span stamps `time.time_ns()` at its
start and end: CLOCK_REALTIME nanoseconds, the clock of the profiler's trace
(`trace_start_ns()` plus an event's `time_range`), and enters
`record_function(name)` inside those stamps, so a profile with CPU activity
shows it among the kernels. Neither launches, copies, records an event or
synchronises on the device. The recorded spans stay in memory, at most
`MAX_SPANS`, until `clear()`.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, List

import numpy as np
import torch

# the profiler's on-flag: true in the thread that runs a torch.profiler
# profile, with CPU or CUDA activity alone (private; checked on torch
# 2.11.0+cu128 with the card and 2.13 on the CPU), false elsewhere
recording = torch._C._autograd._profiler_enabled

# a DDIM-50 clip records about 3,000 spans
MAX_SPANS = 1 << 18


class Recorder:
    """The spans and counts of one process: spans as [name, start_ns,
    end_ns, parent index, clip id, attrs] in the order they started."""

    def __init__(self):
        self.spans: List[list] = []
        self.open: List[int] = []     # recorded spans open now, innermost last
        self.counts: Dict[str, Dict[tuple, int]] = {}
        self.clip = None              # the id of the request running now
        self.clips = 0                # requests seen

    def clear(self) -> None:
        self.spans, self.open, self.counts = [], [], {}


RECORDER = Recorder()


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("rec", "index", "rf")

    def __init__(self, rec: list, index: int):
        self.rec, self.index = rec, index
        self.rf = torch.autograd.profiler.record_function(rec[0])

    def __enter__(self):
        self.rec[1] = time.time_ns()
        self.rf.__enter__()
        RECORDER.open.append(self.index)
        return self

    def __exit__(self, *exc):
        RECORDER.open.pop()
        self.rf.__exit__(*exc)
        self.rec[2] = time.time_ns()
        return None


def span(name: str, **attrs):
    """A named region: recorded, with its parent span and the running
    request's id, while a profiler runs; else the shared null context.
    A span whose start was recorded records its end even if the profiler
    stops inside it."""
    if not recording():
        return NULL_SPAN
    r = RECORDER
    if len(r.spans) >= MAX_SPANS:
        return NULL_SPAN
    rec = [name, None, None, r.open[-1] if r.open else None, r.clip, attrs]
    r.spans.append(rec)
    return _Span(rec, len(r.spans) - 1)


@contextlib.contextmanager
def clip():
    """One request (a `synthesize` call) and its `clip` span: the spans
    recorded inside carry its id, also where the profiler starts after the
    request did and the `clip` span itself is not recorded. Yields the
    id."""
    r = RECORDER
    r.clips += 1
    outer, r.clip = r.clip, r.clips
    try:
        with span("clip"):
            yield r.clip
    finally:
        r.clip = outer


def count(op: str, key: tuple) -> None:
    """One call of kernel wrapper `op` with work set by `key` (shapes and
    dtype), counted while a profiler runs. Callers build the key only when
    `recording()`."""
    if recording():
        ops = RECORDER.counts.setdefault(op, {})
        ops[key] = ops.get(key, 0) + 1


def spans() -> List[dict]:
    """The recorded spans in start order: name, start_ns, end_ns (None
    while open), parent (an index into this list, or None), clip (the
    request's id, or None outside one) and attrs."""
    return [{"name": n, "start_ns": s, "end_ns": e, "parent": p, "clip": c,
             "attrs": dict(a)} for n, s, e, p, c, a in RECORDER.spans]


def counts() -> Dict[str, Dict[tuple, int]]:
    """{op: {key: calls}} counted while a profiler ran."""
    return {op: dict(keys) for op, keys in RECORDER.counts.items()}


def clear() -> None:
    """Drop the recorded spans and counts (not inside a recorded span)."""
    RECORDER.clear()


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block; the trace is written under `logdir` (TensorBoard's
    profiler plugin or Perfetto read it)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=torch.profiler.tensorboard_trace_handler(
                     logdir)) as prof:
        yield prof


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def sync(x) -> None:
    """Wait for the device of the first tensor in `x` (a tensor, or a
    dict, list or tuple holding one); on the CPU, nothing."""
    t = _first_tensor(x)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """{str(device): {bytes_in_use, peak_bytes_in_use, bytes_limit}} per
    CUDA device (torch.cuda.memory_stats, mem_get_info's total); {} without
    a card. A failing read raises."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        dev = torch.device("cuda", i)
        s = torch.cuda.memory_stats(dev)
        out[str(dev)] = {
            "bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.mem_get_info(dev)[1],
        }
    return out


def count_params(params) -> int:
    """Elements of a module's parameters, or of the tensors and arrays in
    a (nested) dict (DynamiCrafter/utils/utils.py:8)."""
    if isinstance(params, torch.nn.Module):
        return sum(p.numel() for p in params.parameters())
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(v) for v in params)
    shape = getattr(params, "shape", None)
    return int(np.prod(shape)) if shape is not None else 0
