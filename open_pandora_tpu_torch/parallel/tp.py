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
flash kernel on the card). The int8 layout waits for models/quant.py.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from open_pandora_tpu_torch.models.llama import LoRALinear
from open_pandora_tpu_torch.parallel.mesh import MeshSpec

_COLUMN = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
_ROW = ("o_proj", "down_proj")


def llama_param_shardings(llama: nn.Module) -> Dict[str, Optional[int]]:
    """{parameter name: the weight dim split over the model axis (0 for
    column-parallel, 1 for row-parallel), or None (replicated)}."""
    out = {}
    for name, _ in llama.named_parameters():
        parts = name.split(".")
        parent, leaf = (parts[-2] if len(parts) > 1 else ""), parts[-1]
        out[name] = (0 if parent in _COLUMN and leaf == "weight" else
                     1 if parent in _ROW and leaf == "weight" else None)
    return out


class RowParallelLinear(nn.Linear):
    """This rank's input columns of a bias-free projection; forward sums
    the ranks' partial products over `group` (forward only)."""

    def __init__(self, weight: torch.Tensor, group):
        super().__init__(weight.shape[1], weight.shape[0], bias=False,
                         device="meta")
        self.weight = nn.Parameter(weight, requires_grad=False)
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.weight)
        if self.group is not None:
            dist.all_reduce(y, group=self.group)
        return y


def _take(w: torch.Tensor, dim: int, n: int, r: int) -> torch.Tensor:
    c = w.shape[dim] // n
    return w.detach().narrow(dim, r * c, c).clone()


def shard_llama_(ms: MeshSpec, llama: nn.Module) -> nn.Module:
    """Split a LlamaForCausalLM's projections over the model axis, in
    place (the full weights are freed); returns it."""
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
                if isinstance(lin, LoRALinear):
                    raise ValueError("tensor parallelism of LoRA adapters "
                                     "is not supported")
                if name in _ROW:
                    setattr(mod, name, RowParallelLinear(
                        _take(lin.weight, 1, n, r), group))
                else:
                    lin.weight = nn.Parameter(_take(lin.weight, 0, n, r),
                                              requires_grad=False)
                    lin.out_features //= n
        layer.self_attn.heads //= n
    return llama
