"""Training-side diffusion math: q_sample, the v target, the loss.

Counterpart of open_pandora_tpu/diffusion/losses.py (reference ddpm3d.py
q_sample :301-304, get_v :306-310, p_losses :741-797, dynamic rescale of
x0 :701-706): v-target MSE with per-sample NaN zeroing. The timesteps and
the noise come from an explicit generator, or from the caller.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from open_pandora_tpu_torch.diffusion.schedule import DiffusionSchedule


def extract(arr: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """arr[t] (fp32) shaped (b, 1, ...) to broadcast over ndim dims."""
    out = arr.to(t.device)[t]
    return out.reshape(out.shape[0], *([1] * (ndim - 1)))


def q_sample(sched: DiffusionSchedule, x_start, t, noise):
    return (extract(sched.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
            + extract(sched.sqrt_one_minus_alphas_cumprod, t, x_start.ndim)
            * noise)


def get_v(sched: DiffusionSchedule, x, noise, t):
    return (extract(sched.sqrt_alphas_cumprod, t, x.ndim) * noise
            - extract(sched.sqrt_one_minus_alphas_cumprod, t, x.ndim) * x)


def diffusion_loss(apply_model: Callable, sched: DiffusionSchedule,
                   x_start: torch.Tensor, *,
                   generator: Optional[torch.Generator] = None,
                   t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None,
                   parameterization: str = "v",
                   use_dynamic_rescale: bool = True,
                   l_simple_weight: float = 1.0):
    """One training-loss evaluation -> (loss, metrics). x_start: clean
    latents (b, t, h, w, c); reductions over every non-batch axis. `t`
    (b,) and `noise` (x_start's shape) are drawn from `generator` unless
    given. apply_model(x_noisy, t) -> the model output."""
    b, dev = x_start.shape[0], x_start.device
    if t is None:
        t = torch.randint(0, sched.num_timesteps, (b,), generator=generator,
                          device=dev)
    t = t.to(dev)
    if use_dynamic_rescale:
        # fp32 from here on, as jnp promotes bf16 * fp32
        x_start = x_start * extract(sched.scale_arr, t, x_start.ndim)
    if noise is None:
        noise = torch.randn(x_start.shape, generator=generator, device=dev,
                            dtype=x_start.dtype)
    noise = noise.to(dev, x_start.dtype)
    model_output = apply_model(q_sample(sched, x_start, t, noise), t)

    if parameterization == "v":
        target = get_v(sched, x_start, noise, t)
    elif parameterization == "eps":
        target = noise
    else:
        target = x_start
    axes = tuple(range(1, x_start.ndim))
    loss_simple = ((model_output.float() - target.float()) ** 2).mean(axes)
    # NaN-zeroing per sample (ddpm3d.py:770-774)
    loss_simple = torch.where(torch.isnan(loss_simple), 0.0, loss_simple)
    loss = l_simple_weight * loss_simple.mean()
    return loss, {"loss_simple": loss_simple.mean().detach(),
                  "loss": loss.detach()}
