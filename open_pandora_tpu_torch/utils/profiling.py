"""Tracing, timing and device-memory readings.

Counterpart of open_pandora_tpu/utils/profiling.py (the reference's
CUDACallback epoch time and peak memory, utils/callbacks.py:104-133):

  - trace(logdir): torch.profiler over the CPU and, where present, CUDA,
    written to `logdir` as a TensorBoard / Chrome trace
  - annotate(name): a named region in the trace (record_function)
  - sync(x): torch.cuda.synchronize on the device of x's first tensor
  - StepTimer: wall-clock step times with a percentile summary
  - device_memory_stats(): per-CUDA-device bytes in use, peak and limit
  - count_params: elements over a module, a state dict or a dict of arrays
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator

import numpy as np
import torch


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


def annotate(name: str):
    """A named region in profiler traces."""
    return torch.profiler.record_function(name)


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


class StepTimer:
    """Rolling step timer with a percentile summary; `tick(result)` syncs
    on the result first, so the time is the device's, not the enqueue."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.times = []
        self._t = None
        self._n = 0

    def tick(self, result=None) -> None:
        if result is not None:
            sync(result)
        now = time.perf_counter()
        if self._t is not None:
            self._n += 1
            if self._n > self.warmup:
                self.times.append(now - self._t)
        self._t = now

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        a = np.asarray(self.times)
        return {"mean_s": float(a.mean()), "p50_s": float(np.median(a)),
                "p90_s": float(np.percentile(a, 90)), "n": len(a)}


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
