"""The (data, model) device mesh and the partition rules.

Counterpart of open_pandora_tpu/parallel/mesh.py (reference
ddp_wrapper.py:8-12, utils/utils_train.py:123-134, config/config.yaml:22).
The JAX package states its parallelism as sharding specs and lets XLA
insert the collectives; here the mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the process group, and the
train step (train/step.py), the optimizer (train/optim.py) and the
parallel/ modules issue the collectives themselves:

  - DDP     == each data rank takes its slice of the global batch, the
               gradients are averaged over the data axis
  - ZeRO-2  == each data rank updates the part of the optimizer state
               `zero2_opt_spec` gives it; the parameters are all-gathered
  - FSDP    == the leaves `fsdp_param_spec` names are stored sharded
               (FSDP2 `fully_shard`)
  - rank-sharded inference == `process_shard_indices`

The rules return, per leaf, the axis it is sharded on over the data axis,
or None for a replicated leaf: the axis of the JAX package's PartitionSpec.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from open_pandora_tpu_torch.core.config import MeshConfig


@dataclass
class MeshSpec:
    """The mesh (None in a single process without a group) and its axes."""

    mesh: Optional["torch.distributed.device_mesh.DeviceMesh"]
    data_axis: str = "data"
    model_axis: str = "model"
    shard_opt_state: bool = True

    def _size(self, axis: str) -> int:
        return 1 if self.mesh is None else self.mesh.size(
            self.mesh.mesh_dim_names.index(axis))

    @property
    def n_data(self) -> int:
        return self._size(self.data_axis)

    @property
    def n_model(self) -> int:
        return self._size(self.model_axis)

    @property
    def data_rank(self) -> int:
        return 0 if self.mesh is None else self.mesh.get_local_rank(
            self.data_axis)

    @property
    def model_rank(self) -> int:
        return 0 if self.mesh is None else self.mesh.get_local_rank(
            self.model_axis)

    @property
    def data_group(self):
        """The process group of this rank's data axis (None: no group)."""
        return None if self.mesh is None else self.mesh.get_group(
            self.data_axis)

    @property
    def model_group(self):
        return None if self.mesh is None else self.mesh.get_group(
            self.model_axis)


def build_mesh(cfg: MeshConfig = MeshConfig(),
               world_size: Optional[int] = None) -> MeshSpec:
    """A (data_axis, model_axis) mesh over the process group's ranks
    (`world_size` of them; the group's size by default, 1 without a
    group). data_parallel == -1 means world_size // model_parallel."""
    group = dist.is_initialized()
    n = world_size if world_size is not None else (
        dist.get_world_size() if group else 1)
    mp = max(1, cfg.model_parallel)
    dp = cfg.data_parallel if cfg.data_parallel > 0 else n // mp
    if dp * mp != n:
        raise ValueError(f"mesh {dp}x{mp} != {n} devices")
    mesh = None
    if group:
        if n != dist.get_world_size():
            raise ValueError(f"mesh over {n} ranks in a group of "
                             f"{dist.get_world_size()}")
        from torch.distributed.device_mesh import init_device_mesh
        kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
        mesh = init_device_mesh(kind, (dp, mp),
                                mesh_dim_names=(cfg.data_axis,
                                                cfg.model_axis))
    elif n != 1:
        raise ValueError(f"a mesh of {n} devices needs a process group "
                         "(parallel.launch.init_distributed under torchrun)")
    return MeshSpec(mesh=mesh, data_axis=cfg.data_axis,
                    model_axis=cfg.model_axis,
                    shard_opt_state=cfg.shard_opt_state)


def shard_rows(x, n: int, rank: int):
    """Rows [rank * b, (rank + 1) * b) of x's leading axis, b = len / n."""
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} not divisible by the data "
                         f"axis {n}")
    b = x.shape[0] // n
    return x[rank * b:(rank + 1) * b]


def shard_batch(ms: MeshSpec, batch: Mapping) -> Dict:
    """This rank's slice of a global batch {name: array or tensor}: the
    leading axis split over the data axis."""
    return {k: shard_rows(v, ms.n_data, ms.data_rank)
            for k, v in batch.items()}


# -- partition rules ----------------------------------------------------------

def _shardable_axis(shape: Sequence[int], n_shard: int) -> Optional[int]:
    """The largest axis divisible by n_shard (the first of equals), or
    None."""
    best = None
    for i, d in enumerate(shape):
        if d % n_shard == 0 and d >= n_shard:
            if best is None or d > shape[best]:
                best = i
    return best


def _spec(shape: Sequence[int], n_shard: int, min_size: int
          ) -> Optional[int]:
    size = int(np.prod(shape)) if len(shape) else 1
    if size < min_size:
        return None
    return _shardable_axis(tuple(shape), n_shard)


def zero2_opt_spec(ms: MeshSpec, tree: Mapping[str, Sequence[int]],
                   min_size: int = 2 ** 16) -> Dict[str, Optional[int]]:
    """ZeRO stage 2 (utils_train.py:125): every optimizer-state leaf (its
    shape) of at least `min_size` elements sharded over the data axis on
    its largest divisible axis; smaller or indivisible leaves replicated
    (None)."""
    return {k: _spec(tuple(v), ms.n_data, min_size)
            for k, v in tree.items()}


def fsdp_param_spec(ms: MeshSpec, tree: Mapping[str, Sequence[int]],
                    min_size: int = 2 ** 16) -> Dict[str, Optional[int]]:
    """FSDP (ChatUniVi/train/train.py:974): every parameter leaf (its shape)
    of at least `min_size` elements sharded over the data axis on its
    largest divisible axis; tiny leaves (norm scales, biases) replicated
    (None), like FSDP's min_num_params."""
    return {k: _spec(tuple(v), ms.n_data, min_size)
            for k, v in tree.items()}


def process_shard_indices(n_items: int) -> range:
    """This process's slice of a work list (reference inference.py:276-282
    rank-sharded prompt lists)."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    per = -(-n_items // world)
    return range(rank * per, min((rank + 1) * per, n_items))


def apply_fsdp(model: torch.nn.Module, ms: MeshSpec,
               min_size: int = 2 ** 16) -> int:
    """Store every parameter `fsdp_param_spec` names sharded over the data
    axis (FSDP2 `fully_shard`, Shard(axis)); returns their count. A unit
    is each module that owns such a parameter, so the parameter is
    gathered around that module's forward. A module class with
    `fsdp_unit = True` is one unit for its whole subtree (its forward reads
    its children's weights), and its `fsdp_methods` are gathered around as
    forward is. The other parameters stay replicated: train/optim.py
    averages their gradients."""
    from torch.distributed.fsdp import (fully_shard,
                                        register_fsdp_forward_method)
    from torch.distributed.tensor import DTensor, Shard

    if ms.mesh is None:
        raise ValueError("fsdp needs a process group "
                         "(parallel.launch.init_distributed)")
    named = dict(model.named_parameters())
    spec = fsdp_param_spec(ms, {k: p.shape for k, p in named.items()},
                           min_size)
    axis = {p: spec[k] for k, p in named.items() if spec[k] is not None}
    inside = {d for m in model.modules() if getattr(m, "fsdp_unit", False)
              for d in m.modules() if d is not m}
    mesh = ms.mesh[ms.data_axis]
    for m in reversed(list(model.modules())):
        if m in inside:
            continue
        own = m.parameters(recurse=getattr(m, "fsdp_unit", False))
        sharded = {p: axis[p] for p in own if p in axis}
        if not sharded:
            continue
        ignored = {p for p in m.parameters()
                   if p not in sharded and not isinstance(p, DTensor)}
        # every unit is a root: resharding after forward is not their
        # default, and a unit with no backward would stay gathered
        fully_shard(m, mesh=mesh, reshard_after_forward=True,
                    shard_placement_fn=lambda p, s=sharded: Shard(s[p]),
                    ignored_params=ignored or None)
        for name in getattr(m, "fsdp_methods", ()):
            register_fsdp_forward_method(m, name)
    return len(axis)
