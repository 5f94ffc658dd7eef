"""LoRA state-dict plumbing for the LLaMA trunk.

Counterpart of open_pandora_tpu/models/lora.py (ChatUniVi trains peft
adapters over every linear module except lm_head, train.py:98-103, and
merges them at load time, model/builder.py:36-47). Here an adapted
projection is a `models.llama.LoRALinear`: its base weight keeps the plain
key (`….q_proj.weight`, (out, in)) and the adapters sit beside it as
`….q_proj.lora_a` (in, r) and `….q_proj.lora_b` (r, out). These functions
convert between the plain and the LoRA state dicts; `add_lora_` grafts
adapters onto a built model.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

LORA_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj",
                "gate_proj", "up_proj", "down_proj")
ADAPTER_LEAVES = ("lora_a", "lora_b")

StateDict = Dict[str, torch.Tensor]


def is_adapter(name: str) -> bool:
    return name.rsplit(".", 1)[-1] in ADAPTER_LEAVES


def add_lora_params(plain: StateDict, lora_template: StateDict) -> StateDict:
    """Graft a plain LLaMA state dict onto the LoRA layout of
    `lora_template` (a LoRA model's state dict): every base tensor from
    `plain`, the adapters keep the template's fresh init."""
    missing = [k for k in lora_template
               if not is_adapter(k) and k not in plain]
    if missing:
        raise KeyError(f"the plain state dict lacks {missing[:3]}")
    return {k: (v if is_adapter(k) else plain[k])
            for k, v in lora_template.items()}


@torch.no_grad()
def merge_lora_params(lora: StateDict, alpha: float, rank: int
                      ) -> StateDict:
    """Deployment merge: W' = W + (A B)ᵀ α/r, the adapters dropped, the
    plain layout restored. A quantized base (int8 or NF4) is refused, as
    in the JAX package: merge before quantization."""
    scale = alpha / rank
    out = {k: v for k, v in lora.items() if not is_adapter(k)}
    for key in lora:
        if not key.endswith(".lora_a"):
            continue
        stem = key[:-len(".lora_a")]
        w = lora.get(f"{stem}.weight")
        if w is None or not w.is_floating_point():
            raise ValueError("merge LoRA before int8 quantization")
        delta = (lora[key] @ lora[f"{stem}.lora_b"]).T * scale
        out[f"{stem}.weight"] = (w + delta).to(w.dtype)
    return out


@torch.no_grad()
def add_lora_(llama: nn.Module, rank: int, alpha: float,
              generator: Optional[torch.Generator] = None) -> nn.Module:
    """add_lora_params on a built model: every target projection of a
    LLaMA without adapters (`models.llama.LlamaForCausalLM`, float or
    quantized) becomes a LoRA projection that holds the same base tensors,
    its adapters freshly initialised (from `generator`) on the model's
    device and in its dtype (the norms'); the model's config then asks
    for the rank. In place; returns `llama`."""
    from open_pandora_tpu_torch.models.llama import LORA_LINEAR

    dtype, dev = llama.model.norm.weight.dtype, llama.model.norm.weight.device
    for layer in llama.model.layers:
        for parent in (layer.self_attn, layer.mlp):
            for name in LORA_TARGETS:
                base = getattr(parent, name, None)
                if base is None:
                    continue
                with torch.device("meta"):
                    lora = LORA_LINEAR[llama.quantized](
                        base.in_features, base.out_features, rank, alpha)
                lora.lora_a = nn.Parameter(torch.empty(
                    lora.lora_a.shape, dtype=dtype, device=dev))
                lora.lora_b = nn.Parameter(torch.empty(
                    lora.lora_b.shape, dtype=dtype, device=dev))
                lora.reset_adapter(generator)
                for key, t in [*base._parameters.items(),
                               *base._buffers.items()]:
                    setattr(lora, key, t)
                setattr(parent, name, lora)
    llama.cfg = dataclasses.replace(llama.cfg, lora_rank=rank,
                                    lora_alpha=alpha)
    return llama
