"""EDM sampling of Stable Video Diffusion: Karras sigmas, the v-prediction
preconditioning with EDM's c_noise, the per-frame linear guidance and the
Euler step.

Follows Stability-AI generative-models: `EDMDiscretization`
(sgm/modules/diffusionmodules/discretizer.py), `VScalingWithEDMcNoise`
(denoiser_scaling.py), `Denoiser` (denoiser.py), `LinearPredictionGuider`
(guiders.py) and `EulerEDMSampler` with s_churn 0 (sampling.py). The
latent is carried in float32 as there: the network's output enters the
preconditioning and the update in float32.
"""

from __future__ import annotations

from typing import Callable

import torch

from open_pandora_tpu_torch.utils.profiling import span


def karras_sigmas(steps: int, sigma_min: float, sigma_max: float,
                  rho: float, device=None) -> torch.Tensor:
    """(steps + 1,) float32: `steps` sigmas from sigma_max down to
    sigma_min on the rho-spaced ramp, then 0."""
    ramp = torch.linspace(0, 1, steps, device=device)
    min_inv_rho = sigma_min ** (1 / rho)
    max_inv_rho = sigma_max ** (1 / rho)
    sigmas = (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho
    return torch.cat([sigmas, sigmas.new_zeros([1])])


def v_scaling(sigma: torch.Tensor):
    """(c_skip, c_out, c_in, c_noise) of a float32 sigma."""
    c_skip = 1.0 / (sigma ** 2 + 1.0)
    c_out = -sigma / (sigma ** 2 + 1.0) ** 0.5
    c_in = 1.0 / (sigma ** 2 + 1.0) ** 0.5
    c_noise = 0.25 * sigma.log()
    return c_skip, c_out, c_in, c_noise


def guidance_scale(min_scale: float, max_scale: float, frames: int,
                   device=None) -> torch.Tensor:
    """(frames,) float32: the guidance scale of each frame, linear from
    min_scale to max_scale."""
    return torch.linspace(min_scale, max_scale, frames, device=device)


def guide(denoised: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """denoised (2b, t, ...) with the unconditional streams first ->
    (b, t, ...): x_u + scale_t (x_c - x_u)."""
    x_u, x_c = denoised.chunk(2)
    s = scale.reshape(1, -1, *([1] * (x_u.ndim - 2)))
    return x_u + s * (x_c - x_u)


def euler_step(x: torch.Tensor, denoised: torch.Tensor, sigma: torch.Tensor,
               next_sigma: torch.Tensor) -> torch.Tensor:
    """x + (next_sigma - sigma) (x - denoised) / sigma."""
    d = (x - denoised) / sigma
    return x + (next_sigma - sigma) * d


def edm_sample(denoise: Callable, x: torch.Tensor, sigmas: torch.Tensor,
               scale: torch.Tensor) -> torch.Tensor:
    """Euler over `sigmas` from the noised start x (float32, already
    scaled by sqrt(1 + sigma_0^2)). `denoise(x2, sigma)` takes both CFG
    streams stacked on the batch axis (unconditional first) and returns
    their denoised latents in float32."""
    for i in range(len(sigmas) - 1):
        with span("edm.step", index=i):
            with span("edm.eval"):
                d2 = denoise(torch.cat([x, x]), sigmas[i])
            with span("edm.guidance"):
                d = guide(d2, scale)
            with span("edm.update"):
                x = euler_step(x, d, sigmas[i], sigmas[i + 1])
    return x
