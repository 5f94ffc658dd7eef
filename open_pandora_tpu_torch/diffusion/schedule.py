"""Diffusion schedules, DDIM discretization and the timestep embedding.

Counterpart of open_pandora_tpu/diffusion/schedule.py. Schedules are built
in float64 NumPy and kept as fp32 tensors.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from open_pandora_tpu_torch.core.config import DiffusionConfig


def make_beta_schedule(n_timesteps: int, linear_start: float,
                       linear_end: float) -> np.ndarray:
    return np.linspace(linear_start ** 0.5, linear_end ** 0.5, n_timesteps,
                       dtype=np.float64) ** 2


def rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """arXiv:2305.08891 Algorithm 1."""
    alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
    abar_sqrt = np.sqrt(alphas_cumprod)
    abar_sqrt_0 = abar_sqrt[0].copy()
    abar_sqrt_T = abar_sqrt[-1].copy()
    abar_sqrt -= abar_sqrt_T
    abar_sqrt *= abar_sqrt_0 / (abar_sqrt_0 - abar_sqrt_T)
    abar = abar_sqrt ** 2
    alphas = np.concatenate([abar[0:1], abar[1:] / abar[:-1]])
    return 1.0 - alphas


@dataclass(frozen=True)
class DiffusionSchedule:
    """Per-timestep arrays, fp32 tensors of shape (N,) on the CPU."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    scale_arr: torch.Tensor  # dynamic rescale, indexed by t
    num_timesteps: int


def make_schedule(cfg: DiffusionConfig) -> DiffusionSchedule:
    betas = make_beta_schedule(cfg.timesteps, cfg.linear_start,
                               cfg.linear_end)
    if cfg.rescale_betas_zero_snr:
        betas = rescale_zero_terminal_snr(betas)
    alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    if cfg.use_dynamic_rescale:
        turning_step = 400
        scale_arr = np.concatenate([
            np.linspace(1.0, cfg.base_scale, turning_step),
            np.full(cfg.timesteps, cfg.base_scale)])
    else:
        scale_arr = np.ones(cfg.timesteps)

    def f32(x):
        return torch.tensor(np.asarray(x), dtype=torch.float32, device="cpu")

    return DiffusionSchedule(
        betas=f32(betas),
        alphas_cumprod=f32(alphas_cumprod),
        alphas_cumprod_prev=f32(alphas_cumprod_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
        scale_arr=f32(scale_arr),
        num_timesteps=cfg.timesteps,
    )


def make_ddim_timesteps(method: str, num_ddim_steps: int,
                        num_ddpm_steps: int) -> np.ndarray:
    """Ascending int64 DDIM timesteps for 'uniform' | 'uniform_trailing' |
    'quad' spacing."""
    if method == "uniform":
        c = num_ddpm_steps // num_ddim_steps
        steps = np.asarray(list(range(0, num_ddpm_steps, c))) + 1
    elif method == "uniform_trailing":
        c = num_ddpm_steps / num_ddim_steps
        steps = np.flip(np.round(np.arange(num_ddpm_steps, 0, -c))
                        ).astype(np.int64) - 1
    elif method == "quad":
        steps = (np.linspace(0, np.sqrt(num_ddpm_steps * 0.8),
                             num_ddim_steps) ** 2).astype(int) + 1
    else:
        raise NotImplementedError(f"unknown ddim discretization {method!r}")
    return steps.astype(np.int64)


def make_ddim_params(alphas_cumprod: np.ndarray, ddim_timesteps: np.ndarray,
                     eta: float):
    """alphas, alphas_prev and sigmas per DDIM step, float64."""
    alphas_cumprod = np.asarray(alphas_cumprod, dtype=np.float64)
    a = alphas_cumprod[ddim_timesteps]
    a_prev = np.asarray([alphas_cumprod[0]]
                        + alphas_cumprod[ddim_timesteps[:-1]].tolist())
    sigmas = eta * np.sqrt((1 - a_prev) / (1 - a) * (1 - a / a_prev))
    return a, a_prev, sigmas


def bf16_freq_table(half: int, max_period: int = 10000) -> torch.Tensor:
    """The reference's bfloat16 frequency table, bit-exact: each step is
    computed wide and rounded to bf16, as torch evaluates
    `scalar * bf16_tensor`."""
    bf16 = torch.bfloat16
    i = torch.arange(half, dtype=torch.float64)
    a = (-math.log(max_period) * i).to(bf16)
    a = (a.double() / half).to(bf16)
    return torch.exp(a.float()).to(bf16).float()


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embedding (b,) -> (b, dim) fp32, [cos | sin]."""
    half = dim // 2
    freqs = bf16_freq_table(half, max_period).to(timesteps.device)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb
