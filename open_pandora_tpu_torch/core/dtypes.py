"""Explicit dtype policy, on torch dtypes.

Counterpart of open_pandora_tpu/core/dtypes.py: precision is one policy
of three dtypes,

  - params:   storage dtype of weights
  - compute:  matmul / conv input dtype (bf16 by default)
  - accum:    reductions, softmax and schedule dtype (always fp32)

`golden_fp32_policy()` is the strict-parity mode (BASELINE.md config 1).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class DTypePolicy:
    param_dtype: torch.dtype
    compute_dtype: torch.dtype
    accum_dtype: torch.dtype = torch.float32

    def cast_compute(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype) if x.dtype != self.compute_dtype \
            else x

    def cast_accum(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.accum_dtype) if x.dtype != self.accum_dtype else x


def default_policy() -> DTypePolicy:
    return DTypePolicy(param_dtype=torch.bfloat16,
                       compute_dtype=torch.bfloat16)


def golden_fp32_policy() -> DTypePolicy:
    return DTypePolicy(param_dtype=torch.float32, compute_dtype=torch.float32)


def policy_from_name(name: str) -> DTypePolicy:
    if name in ("bf16", "bfloat16", "mixed"):
        return default_policy()
    if name in ("fp32", "float32", "golden"):
        return golden_fp32_policy()
    raise ValueError(f"unknown dtype policy {name!r}")
