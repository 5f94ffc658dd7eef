"""Process-group start-up under torchrun.

Counterpart of open_pandora_tpu/parallel/launch.py (reference
`torch.distributed.launch` + NCCL env:// bootstrap, README.md:76-105,
ddp_wrapper.py:8-12). torchrun starts one process per card and names it
in the environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT); `init_distributed` reads it, binds the process to
cuda:LOCAL_RANK and opens an NCCL group there, or a gloo group when the
caller asks for the CPU.

Unlike the JAX package, which stays single-host when
`jax.distributed.initialize` fails, a group that cannot form raises: a
process that was told it is one of N and trains alone would write a
model that no run asked for.

Usage (every entry point calls it; a single process is a no-op):
    torchrun --nproc-per-node 4 -m open_pandora_tpu_torch.train.trainer ...
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

log = logging.getLogger("open_pandora_tpu_torch.launch")


def init_distributed(device="cuda", *,
                     timeout: Optional[datetime.timedelta] = None) -> bool:
    """Open the process group torchrun's environment names. Returns True
    when a group is open (also one of a single rank started by torchrun),
    False in a plain single process, where it does nothing. `device`:
    "cuda" opens NCCL on cuda:LOCAL_RANK, "cpu" opens gloo. `timeout`
    bounds the rendezvous and every collective."""
    if "WORLD_SIZE" not in os.environ:
        return False
    if dist.is_initialized():
        return True
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    kind = torch.device(device).type
    if kind == "cuda":
        torch.cuda.set_device(local_rank)
        backend = "nccl"
        bound = torch.device("cuda", local_rank)
    elif kind == "cpu":
        backend, bound = "gloo", None
    else:
        raise ValueError(f"init_distributed: no backend for {device!r}")
    kw = {"timeout": timeout} if timeout is not None else {}
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world, device_id=bound, **kw)
    log.info("distributed: rank %d/%d (local %d) on %s over %s", rank,
             world, local_rank, device, backend)
    return True


def local_device(device="cuda") -> torch.device:
    """The device this process runs on: cuda:LOCAL_RANK under torchrun,
    else `device` as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return dev


def is_writer() -> bool:
    """True on the process that writes files (rank 0, or a lone process)."""
    return not dist.is_initialized() or dist.get_rank() == 0
