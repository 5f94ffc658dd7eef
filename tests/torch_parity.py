"""Helpers for the parity tests of the PyTorch port (tests/test_torch_*.py)
against the JAX package: seeded weights made with NumPy, loaded into a port
module and converted to the JAX params tree by the JAX package's own
converters; config translation between the two packages."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import torch

from open_pandora_tpu.core import config as jcfg
from open_pandora_tpu_torch.core import config as tcfg


def rerandomize_(module: torch.nn.Module, seed: int) -> dict:
    """Replace every parameter with seeded NumPy gaussians, zero-initialised
    layers included: matrices and kernels std 0.1, 1-D weights (norm
    scales) 1 +- 0.05, other 1-D tensors 0 +- 0.05. Returns the state dict
    as {key: float32 ndarray}."""
    rng = np.random.default_rng(seed)
    flat = {}
    for k, v in module.state_dict().items():
        r = rng.standard_normal(tuple(v.shape)).astype(np.float32)
        if v.ndim >= 2:
            flat[k] = r * np.float32(0.1)
        else:
            base = 1.0 if k.endswith("weight") else 0.0
            flat[k] = np.float32(base) + r * np.float32(0.05)
    module.load_state_dict({k: torch.from_numpy(a) for k, a in flat.items()},
                           strict=True)
    return flat


def prefixed(flat: dict, prefix: str) -> dict:
    return {f"{prefix}.{k}": v for k, v in flat.items()}


def to_jax(tree):
    return jtu.tree_map(lambda x: jnp.asarray(x, jnp.float32), tree)


def jax_sub_config(cfg):
    """The JAX package's dataclass of the same name and values (a plain
    field value as it is)."""
    if not dataclasses.is_dataclass(cfg):
        return cfg
    return getattr(jcfg, type(cfg).__name__)(**dataclasses.asdict(cfg))


def jax_config(cfg: tcfg.PandoraConfig) -> jcfg.PandoraConfig:
    """The JAX package's PandoraConfig with the same sub-config values."""
    return jcfg.PandoraConfig(**{
        f.name: jax_sub_config(getattr(cfg, f.name))
        for f in dataclasses.fields(cfg)})


def max_abs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))
