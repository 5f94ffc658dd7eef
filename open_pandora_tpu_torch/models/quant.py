"""Weight-only int8 and NF4 quantization of the frozen LLaMA.

Counterpart of open_pandora_tpu/models/quant.py, on the port's nn.Linear
layout (out, in). The LLM is frozen in every training stage, so the
quantization error is an inference trade-off, applied after the weights
exist (a checkpoint loaded or random weights drawn).

  int8   per output channel, symmetric: scale = max|w| / 127 over the input
         axis (1 where a row is all zero), codes round(w / scale) half to
         even, clipped to +-127. Buffers `weight_q` int8 (out, in) and
         `scale` fp32 (out,).
  NF4    blocks of 64 along the input axis share one absmax (1 where a
         block is all zero); w / absmax snaps to the nearest entry of the
         16-entry normal-float codebook (the first on a tie), two codes a
         byte along the input axis, the even input column in the low
         nibble. Buffers `weight_p` uint8 (out, in / 2) and `absmax` fp32
         (out, ceil(in / 64)).

The codes, scales and absmax equal the JAX package's bit for bit,
transposed: JAX keeps (in, out). Dequantization follows its rounding
order, the codes times the scale in fp32, then the cast to the compute
dtype. `quantize_llama_` quantizes a built model on its own device, one
projection at a time, each float weight freed as it goes: at full width
the float LLaMA is 6.7 B parameters.

Without a checkpoint the entry points quantize the random float LLaMA.
The JAX package's quantized init is codes 0 and scales 1, which makes
every projection 0; quantizing random weights keeps the numbers on the
card non-degenerate.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

QUANT_MODES = ("int8", "nf4")
# the projections that get quantized: every LLaMA Linear (lm_head included)
QUANT_LEAF_MODULES = ("q_proj", "k_proj", "v_proj", "o_proj",
                      "gate_proj", "up_proj", "down_proj", "lm_head")

# 16-entry normalized-float-4 codebook (QLoRA appendix E): quantiles of
# N(0, 1) scaled to [-1, 1]
NF4_CODE = (
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0)
NF4_BLOCK = 64
# output rows snapped to the codebook at a time: the (rows, in, 16)
# distances stay under 400 MB at the LLaMA's widths
_NF4_ROWS = 512


def quant_mode(quantize) -> Union[bool, str]:
    """The JAX flag's values: False, True (= "int8"), "int8" or "nf4"."""
    if quantize is True:
        return "int8"
    if quantize and quantize not in QUANT_MODES:
        raise ValueError(f"quantize_llm={quantize!r}: expected one of "
                         f"{QUANT_MODES}")
    return quantize or False


def nf4_code(device=None) -> torch.Tensor:
    return torch.tensor(NF4_CODE, dtype=torch.float32, device=device)


@torch.no_grad()
def quantize_kernel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, in) float -> (weight_q int8 (out, in), scale fp32 (out,)).
    The one fp32 temporary is w / scale, rounded and clipped in place: a
    bf16 w is promoted exactly, so the codes equal those of w.float()."""
    scale = w.abs().amax(dim=1).float() / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = (w / scale[:, None]).round_().clamp_(-127, 127).to(torch.int8)
    return q, scale


def dequantize_kernel(weight_q: torch.Tensor, scale: torch.Tensor,
                      dtype=torch.bfloat16) -> torch.Tensor:
    return (weight_q.float() * scale[:, None]).to(dtype)


@torch.no_grad()
def quantize_kernel_nf4(w: torch.Tensor, block: int = NF4_BLOCK
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, in) float, in even -> (weight_p uint8 (out, in / 2),
    absmax fp32 (out, ceil(in / block)))."""
    n_out, n_in = w.shape
    if n_in % 2:
        raise ValueError(f"input width {n_in} must be even to pack two "
                         "codes a byte")
    n_blk = -(-n_in // block)
    code = nf4_code(w.device)
    packed = torch.empty((n_out, n_in // 2), dtype=torch.uint8,
                         device=w.device)
    absmax = torch.empty((n_out, n_blk), dtype=torch.float32,
                         device=w.device)
    for r0 in range(0, n_out, _NF4_ROWS):
        rows = w[r0:r0 + _NF4_ROWS].float()
        wp = F.pad(rows, (0, n_blk * block - n_in)).view(-1, n_blk, block)
        amax = wp.abs().amax(dim=2)
        amax = torch.where(amax == 0, torch.ones_like(amax), amax)
        norm = (wp / amax[:, :, None]).view(rows.shape[0], -1)[:, :n_in]
        codes = (norm[..., None] - code).abs_().argmin(dim=-1)
        codes = codes.to(torch.uint8)
        packed[r0:r0 + _NF4_ROWS] = codes[:, 0::2] | (codes[:, 1::2] << 4)
        absmax[r0:r0 + _NF4_ROWS] = amax
    return packed, absmax


def dequantize_kernel_nf4(weight_p: torch.Tensor, absmax: torch.Tensor,
                          dtype=torch.bfloat16, block: int = NF4_BLOCK
                          ) -> torch.Tensor:
    """Inverse of quantize_kernel_nf4: unpack the nibbles, look the codes
    up, rescale per block in fp32, cast."""
    n_out, n_half = weight_p.shape
    n_in = 2 * n_half
    codes = torch.stack([weight_p & 0xF, weight_p >> 4], dim=-1)
    vals = nf4_code(weight_p.device)[codes.view(n_out, n_in).long()]
    scale = absmax.repeat_interleave(block, dim=1)[:, :n_in]
    return (vals * scale).to(dtype)


class QuantLinear(nn.Module):
    """A bias-free weight-only quantized projection. Its fp32 buffers (the
    scales) stay fp32 through `.to(dtype)`, as the JAX package keeps them;
    they follow the module's device."""

    _fp32: Tuple[str, ...] = ()

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features

    def dequantized(self, dtype: torch.dtype) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the dequantized copy lives for this product only
        return F.linear(x, self.dequantized(x.dtype))

    def _apply(self, fn, recurse=True):
        keep = {n: self._buffers.pop(n) for n in self._fp32}
        super()._apply(fn, recurse)
        for n, t in keep.items():
            moved = fn(t)
            self._buffers[n] = (moved if moved.dtype == t.dtype
                                else t.to(moved.device))
        return self


class Int8Linear(QuantLinear):
    """JAX `Int8Dense`: weight_q int8 (out, in), scale fp32 (out,)."""

    _fp32 = ("scale",)

    def __init__(self, in_features: int, out_features: int):
        super().__init__(in_features, out_features)
        self.register_buffer("weight_q", torch.zeros(
            (out_features, in_features), dtype=torch.int8))
        self.register_buffer("scale", torch.ones(out_features))

    def dequantized(self, dtype: torch.dtype) -> torch.Tensor:
        return dequantize_kernel(self.weight_q, self.scale, dtype)

    @torch.no_grad()
    def set_weight_(self, w: torch.Tensor) -> "Int8Linear":
        self.weight_q, self.scale = quantize_kernel(w)
        return self


class NF4Linear(QuantLinear):
    """JAX `Int4Dense`: weight_p uint8 (out, in / 2), absmax fp32
    (out, in / 64)."""

    _fp32 = ("absmax",)

    def __init__(self, in_features: int, out_features: int):
        super().__init__(in_features, out_features)
        self.register_buffer("weight_p", torch.zeros(
            (out_features, in_features // 2), dtype=torch.uint8))
        self.register_buffer("absmax", torch.ones(
            out_features, -(-in_features // NF4_BLOCK)))

    def dequantized(self, dtype: torch.dtype) -> torch.Tensor:
        return dequantize_kernel_nf4(self.weight_p, self.absmax, dtype)

    @torch.no_grad()
    def set_weight_(self, w: torch.Tensor) -> "NF4Linear":
        self.weight_p, self.absmax = quantize_kernel_nf4(w)
        return self


QUANT_LINEAR = {"int8": Int8Linear, "nf4": NF4Linear}


def quantize_llama_params(state: Dict[str, torch.Tensor], mode: str = "int8"
                          ) -> Dict[str, torch.Tensor]:
    """A float LLaMA state dict -> the quantized modules' state dict:
    every projection's `….weight` becomes `….weight_q` and `….scale`
    (int8) or `….weight_p` and `….absmax` (nf4); everything else is kept."""
    mode = quant_mode(mode)
    names = ("weight_q", "scale") if mode == "int8" else ("weight_p",
                                                          "absmax")
    qfn = quantize_kernel if mode == "int8" else quantize_kernel_nf4
    out = {}
    for key, v in state.items():
        stem, _, leaf = key.rpartition(".")
        if leaf == "weight" and stem.rpartition(".")[2] in QUANT_LEAF_MODULES:
            out.update(zip((f"{stem}.{n}" for n in names), qfn(v)))
        else:
            out[key] = v
    return out


@torch.no_grad()
def quantize_llama_(llama: nn.Module, mode="int8") -> nn.Module:
    """Quantize a built float `models.llama.LlamaForCausalLM` in place, on
    its device: each projection (a LoRA projection's base, lm_head
    included) is quantized from its weight, which is then dropped, before
    the next. Sets `llama.quantized`; returns `llama`."""
    from open_pandora_tpu_torch.models.llama import LORA_LINEAR, LoRAAdapter

    mode = quant_mode(mode)
    if not mode:
        return llama
    if llama.quantized:
        raise ValueError(f"the LLaMA is already quantized ({llama.quantized})")
    # the decoder layers' projections and lm_head only: a WorldModel's
    # CLIP tower sits under llama.model too, with projections of the
    # same names
    parents = [llama] + [p for layer in llama.model.layers
                         for p in (layer.self_attn, layer.mlp)]
    # names only: a list of the modules would keep every float weight
    # alive until the last is quantized
    targets = [(parent, name) for parent in parents
               for name, _ in parent.named_children()
               if name in QUANT_LEAF_MODULES]
    for parent, name in targets:
        lin = getattr(parent, name)
        w = lin.weight
        with torch.device("meta"):
            if isinstance(lin, LoRAAdapter):
                q = LORA_LINEAR[mode](lin.in_features, lin.out_features,
                                      lin.rank, lin.alpha)
            else:
                q = QUANT_LINEAR[mode](lin.in_features, lin.out_features)
        if isinstance(lin, LoRAAdapter):
            q.lora_a, q.lora_b = lin.lora_a, lin.lora_b
        q.set_weight_(w)
        setattr(parent, name, q)
        del lin, w
    llama.quantized = mode
    return llama


def tree_nbytes(tensors: Union[nn.Module, Dict[str, torch.Tensor],
                               Iterable[torch.Tensor]]) -> int:
    """Bytes of a module's parameters and buffers, of a state dict's
    values, or of an iterable of tensors."""
    if isinstance(tensors, nn.Module):
        tensors = list(tensors.parameters()) + list(tensors.buffers())
    elif isinstance(tensors, dict):
        tensors = tensors.values()
    return sum(t.numel() * t.element_size() for t in tensors)
