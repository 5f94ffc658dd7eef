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


def jax_finetune_draws(key, uncond_prob: float, timesteps: int, batch: int,
                       latent_shape) -> dict:
    """The draws the JAX finetune losses make from `key` (train/step.py
    `_finetune_loss` and `make_wm_finetune_step`'s loss_fn split it into
    k_enc, k_drop, k_diff, k_dropout; diffusion/losses.py splits k_diff
    into t and noise), as NumPy arrays for the port's `draws`."""
    import jax

    k_enc, k_drop, k_diff, _ = jax.random.split(key, 4)
    t_key, n_key = jax.random.split(k_diff)
    return {
        "eps": np.asarray(jax.random.normal(k_enc, latent_shape)),
        "uncond": np.asarray(jax.random.bernoulli(
            k_drop, uncond_prob, (batch, 1, 1))).reshape(batch),
        "t": np.asarray(jax.random.randint(t_key, (batch,), 0, timesteps)),
        "noise": np.asarray(jax.random.normal(n_key, latent_shape)),
    }
