"""Tensor parallelism of the LLaMA projections over the mesh's model axis.

Counterpart of open_pandora_tpu/parallel/tp.py:29 (a capability the
reference lacks, SURVEY.md section 2.7), on the port's nn.Linear layout
(out, in): Megatron column / row partitioning, forward only.

  q / k / v / gate / up   column-parallel: weight rows (out) split, so
                          each rank holds whole heads and whole MLP columns
  o / down                row-parallel: weight columns (in) split; the
                          partial products are all-reduced over the axis
  embeddings, norms, lm_head   replicated

Each rank's attention runs on its own heads through ops.attention (the
flash kernel on the card).

Quantized projections (models/quant.py), as JAX `llama_param_shardings`:
  int8   column-parallel: `weight_q` rows split, `scale` split with them;
         row-parallel: `weight_q` columns split, `scale` replicated
  NF4    replicated: each rank keeps the whole projection (JAX's NF4
         leaves fall through to replicated) and, at each call, takes its
         rows (column-parallel) or columns (row-parallel) of the
         dequantized weight, so the ranks give the one-device result
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from open_pandora_tpu_torch.models.llama import LoRAAdapter
from open_pandora_tpu_torch.models.quant import Int8Linear, NF4Linear
from open_pandora_tpu_torch.parallel.mesh import MeshSpec

_COLUMN = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
_ROW = ("o_proj", "down_proj")


def llama_param_shardings(llama: nn.Module) -> Dict[str, Optional[int]]:
    """{parameter or buffer name: the weight dim split over the model axis
    (0 for column-parallel, 1 for row-parallel), or None (replicated)}."""
    out = {}
    for name, t in [*llama.named_parameters(), *llama.named_buffers()]:
        parts = name.split(".")
        parent, leaf = (parts[-2] if len(parts) > 1 else ""), parts[-1]
        out[name] = (0 if parent in _COLUMN and leaf in ("weight", "weight_q")
                     else 0 if parent in _COLUMN and leaf == "scale"
                     else 1 if parent in _ROW and leaf in ("weight",
                                                           "weight_q")
                     else None)
    return out


class RowParallelLinear(nn.Module):
    """A projection `base` that holds this rank's input columns; forward
    sums the ranks' partial products over `group` (forward only)."""

    def __init__(self, base: nn.Module, group):
        super().__init__()
        self.base, self.group = base, group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.base(x)
        if self.group is not None:
            dist.all_reduce(y, group=self.group)
        return y


class NF4Shard(nn.Module):
    """A whole NF4 projection of which this rank uses the rows (dim 0) or
    columns (dim 1) [start, start + size) of the dequantized weight."""

    def __init__(self, base: NF4Linear, dim: int, n: int, r: int):
        super().__init__()
        self.base, self.dim = base, dim
        full = base.out_features if dim == 0 else base.in_features
        self.size = full // n
        self.start = r * self.size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.base.dequantized(x.dtype).narrow(self.dim, self.start,
                                                  self.size)
        return F.linear(x, w)


def _take(w: torch.Tensor, dim: int, n: int, r: int) -> torch.Tensor:
    c = w.shape[dim] // n
    return w.detach().narrow(dim, r * c, c).clone()


def _split(lin: nn.Module, dim: int, n: int, r: int) -> nn.Module:
    """Rank r's rows (dim 0) or columns (dim 1) of a projection, the full
    tensors freed: float and int8 are cut, NF4 is kept whole."""
    if isinstance(lin, NF4Linear):
        return NF4Shard(lin, dim, n, r)
    if isinstance(lin, Int8Linear):
        lin.weight_q = _take(lin.weight_q, dim, n, r)
        if dim == 0:
            lin.scale = _take(lin.scale, 0, n, r)
    else:
        lin.weight = nn.Parameter(_take(lin.weight, dim, n, r),
                                  requires_grad=False)
    if dim == 0:
        lin.out_features //= n
    else:
        lin.in_features //= n
    return lin


def shard_llama_(ms: MeshSpec, llama: nn.Module) -> nn.Module:
    """Split a LlamaForCausalLM's projections (float, int8 or NF4) over
    the model axis, in place; returns it."""
    n, r, group = ms.n_model, ms.model_rank, ms.model_group
    cfg = llama.cfg
    if cfg.num_heads % n or cfg.intermediate_size % n:
        raise ValueError(f"heads {cfg.num_heads} and MLP width "
                         f"{cfg.intermediate_size} must divide by the "
                         f"model axis {n}")
    for layer in llama.model.layers:
        for mod in (layer.self_attn, layer.mlp):
            for name in _COLUMN + _ROW:
                lin = getattr(mod, name, None)
                if lin is None:
                    continue
                if isinstance(lin, LoRAAdapter):
                    raise ValueError("tensor parallelism of LoRA adapters "
                                     "is not supported")
                if name in _ROW:
                    setattr(mod, name, RowParallelLinear(
                        _split(lin, 1, n, r), group))
                else:
                    setattr(mod, name, _split(lin, 0, n, r))
        layer.self_attn.heads //= n
    return llama
