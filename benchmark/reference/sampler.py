"""Plain reference of the DDPM schedule and of one DDIM step: zero-terminal-
SNR betas, v-parameterisation, batched classifier-free guidance with
guidance rescale, the dynamic rescale of the predicted x0, and eta.

Schedules in float64 NumPy, kept as float32; the step in float32.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch


def alphas_cumprod(d: SimpleNamespace) -> np.ndarray:
    betas = np.linspace(d.linear_start ** 0.5, d.linear_end ** 0.5,
                        d.timesteps, dtype=np.float64) ** 2
    if d.rescale_betas_zero_snr:
        ac = np.cumprod(1.0 - betas)
        s = np.sqrt(ac)
        s0, sT = s[0].copy(), s[-1].copy()
        s = (s - sT) * s0 / (s0 - sT)
        ab = s ** 2
        betas = 1.0 - np.concatenate([ab[0:1], ab[1:] / ab[:-1]])
    return np.cumprod(1.0 - betas)


def ddim_steps(d: SimpleNamespace, steps: int, eta: float) -> dict:
    """Per-step float32 coefficients in sampling order (descending t),
    uniform_trailing spacing."""
    n = d.timesteps
    ts = np.flip(np.round(np.arange(n, 0, -n / steps))).astype(np.int64) - 1
    ac = alphas_cumprod(d).astype(np.float32).astype(np.float64)
    a = ac[ts]
    a_prev = np.asarray([ac[0]] + ac[ts[:-1]].tolist())
    sigma = eta * np.sqrt((1 - a_prev) / (1 - a) * (1 - a / a_prev))
    scale = np.concatenate([np.linspace(1.0, d.base_scale, 400),
                            np.full(n, d.base_scale)])
    scale = scale.astype(np.float32).astype(np.float64)[ts]
    rescale = np.concatenate([scale[0:1], scale[:-1]]) / scale

    def flip(x):
        return np.flip(np.asarray(x)).astype(np.float32)

    return {"t": np.flip(ts).astype(np.int64), "sqrt_a": flip(np.sqrt(a)),
            "sqrt_1ma": flip(np.sqrt(1.0 - a)), "a_prev": flip(a_prev),
            "sigma": flip(sigma), "rescale": flip(rescale)}


def guide(out: torch.Tensor, scale: float, rescale: float) -> torch.Tensor:
    """The batched CFG output (cond; uncond) -> the guided prediction, with
    guidance rescale (arXiv:2305.08891 sec 3.4)."""
    cond, uncond = out.float().chunk(2)
    g = uncond + scale * (cond - uncond)
    if rescale > 0:
        dims = tuple(range(1, g.ndim))
        g_r = g * (cond.std(dim=dims, keepdim=True, correction=0)
                   / g.std(dim=dims, keepdim=True, correction=0))
        g = rescale * g_r + (1.0 - rescale) * g
    return g


def step(x: torch.Tensor, v: torch.Tensor, noise: torch.Tensor,
         sch: dict, i: int) -> torch.Tensor:
    """x_t, the guided v prediction and the step's unit noise -> x_{t-1}
    (float32)."""
    xf = x.float()
    sa, s1 = float(sch["sqrt_a"][i]), float(sch["sqrt_1ma"][i])
    e_t = sa * v + s1 * xf
    x0 = (sa * xf - s1 * v) * float(sch["rescale"][i])
    a_prev, sigma = sch["a_prev"][i], sch["sigma"][i]
    dir_coef = float(np.sqrt(max(np.float32(1.0) - a_prev - sigma ** 2,
                                 np.float32(0.0))))
    return (float(np.sqrt(a_prev)) * x0 + dir_coef * e_t
            + float(sigma) * noise.float())
