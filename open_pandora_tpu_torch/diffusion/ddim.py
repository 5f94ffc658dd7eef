"""DDIM sampler: a host loop over steps, one denoiser call per step.

Counterpart of open_pandora_tpu/diffusion/ddim.py: 2-way and 3-way CFG
with the streams stacked on the batch axis (one UNet eval per step),
guidance_rescale, v-parameterization, the dynamic-rescale correction and
eta. The per-step noise can be injected (a callable or a list of tensors),
so a test can feed the JAX package's draws; otherwise it comes from a
torch.Generator on the latents' device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from open_pandora_tpu_torch.diffusion.schedule import (DiffusionSchedule,
                                                       make_ddim_params,
                                                       make_ddim_timesteps)
from open_pandora_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class DDIMParams:
    """Per-step values in sampling order (descending t): int64 timesteps and
    fp32 coefficients, as NumPy arrays of shape (S,)."""

    ts: np.ndarray
    a_t: np.ndarray
    a_prev: np.ndarray
    sigma_t: np.ndarray
    sqrt_one_minus_at: np.ndarray
    sqrt_ac_t: np.ndarray
    sqrt_1mac_t: np.ndarray
    rescale_t: np.ndarray

    @property
    def num_steps(self) -> int:
        return int(self.ts.shape[0])


def make_ddim_schedule(sched: DiffusionSchedule, steps: int, eta: float,
                       timestep_spacing: str = "uniform_trailing",
                       use_dynamic_rescale: bool = True) -> DDIMParams:
    ddim_ts = make_ddim_timesteps(timestep_spacing, steps,
                                  sched.num_timesteps)
    ac = sched.alphas_cumprod.double().numpy()
    a, a_prev, sigmas = make_ddim_params(ac, ddim_ts, eta)
    if use_dynamic_rescale:
        scale = sched.scale_arr.double().numpy()[ddim_ts]
        rescale = np.concatenate([scale[0:1], scale[:-1]]) / scale
    else:
        rescale = np.ones_like(a)

    def flip(x):
        return np.flip(np.asarray(x)).astype(np.float32)

    return DDIMParams(
        ts=np.flip(ddim_ts).astype(np.int64),
        a_t=flip(a), a_prev=flip(a_prev), sigma_t=flip(sigmas),
        sqrt_one_minus_at=flip(np.sqrt(1.0 - a)), sqrt_ac_t=flip(np.sqrt(a)),
        sqrt_1mac_t=flip(np.sqrt(1.0 - a)), rescale_t=flip(rescale))


def rescale_noise_cfg(noise_cfg: torch.Tensor, noise_pred_text: torch.Tensor,
                      guidance_rescale: float) -> torch.Tensor:
    """arXiv:2305.08891 sec 3.4 (population std over all but batch)."""
    dims = tuple(range(1, noise_pred_text.ndim))
    std_text = noise_pred_text.std(dim=dims, keepdim=True, correction=0)
    std_cfg = noise_cfg.std(dim=dims, keepdim=True, correction=0)
    rescaled = noise_cfg * (std_text / std_cfg)
    return guidance_rescale * rescaled + (1.0 - guidance_rescale) * noise_cfg


# model_fn(x, t_b) -> {'cond': ..., optionally 'uncond', 'uncond_img'}
ModelFn = Callable[[torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]]
# noise(step_index, x) -> standard normal tensor shaped like x
NoiseFn = Callable[[int, torch.Tensor], torch.Tensor]


def _guide(outs: Dict[str, torch.Tensor], guidance_scale: float,
           cfg_img: Optional[float], guidance_rescale: float) -> torch.Tensor:
    """The CFG combine of the streams' outputs, then the rescale."""
    e_cond = outs["cond"].float()
    if guidance_scale == 1.0 or "uncond" not in outs:
        model_output = e_cond
    elif cfg_img is not None and "uncond_img" in outs:
        e_uc = outs["uncond"].float()
        e_uc_img = outs["uncond_img"].float()
        model_output = (e_uc + cfg_img * (e_uc_img - e_uc)
                        + guidance_scale * (e_cond - e_uc_img))
    else:
        e_uc = outs["uncond"].float()
        model_output = e_uc + guidance_scale * (e_cond - e_uc)
    if guidance_rescale > 0.0:
        model_output = rescale_noise_cfg(model_output, e_cond,
                                         guidance_rescale)
    return model_output


def _update(x: torch.Tensor, model_output: torch.Tensor, params: DDIMParams,
            idx: int, noise, generator, parameterization: str
            ) -> torch.Tensor:
    """One DDIM step from x with the guided output: v (or eps) to x0, the
    dynamic rescale, the noise draw, the new x."""
    xf = x.float()
    sqrt_ac = float(params.sqrt_ac_t[idx])
    sqrt_1mac = float(params.sqrt_1mac_t[idx])
    if parameterization == "v":
        e_t = sqrt_ac * model_output + sqrt_1mac * xf
        pred_x0 = sqrt_ac * xf - sqrt_1mac * model_output
    else:
        e_t = model_output
        pred_x0 = (xf - float(params.sqrt_one_minus_at[idx]) * e_t) \
            / float(np.sqrt(params.a_t[idx]))
    pred_x0 = pred_x0 * float(params.rescale_t[idx])

    a_prev = params.a_prev[idx]
    sigma_t = params.sigma_t[idx]
    dir_coef = np.sqrt(np.maximum(np.float32(1.0) - a_prev - sigma_t ** 2,
                                  np.float32(0.0)))
    dir_xt = float(dir_coef) * e_t
    if noise is None:
        z = torch.randn(x.shape, generator=generator, device=x.device,
                        dtype=x.dtype)
    elif callable(noise):
        z = noise(idx, x)
    else:
        z = noise[idx]
    z = float(sigma_t) * z.to(x.device).float()
    return (float(np.sqrt(a_prev)) * pred_x0 + dir_xt + z).to(x.dtype)


def ddim_sample(model_fn: ModelFn, params: DDIMParams, x_T: torch.Tensor, *,
                noise: Union[None, NoiseFn, Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                guidance_scale: float = 1.0, cfg_img: Optional[float] = None,
                guidance_rescale: float = 0.0,
                parameterization: str = "v") -> torch.Tensor:
    """Run the DDIM reverse process from x_T; returns x_0 latents.

    noise: per-step standard normal draws, as noise(idx, x) or a sequence
    indexed by step; None draws them with `generator` on x's device.
    Under a profiler each step records a `ddim.step` span (its index in
    attrs) holding `ddim.eval`, `ddim.guidance` and `ddim.update`."""
    if noise is None and generator is None:
        raise ValueError("ddim_sample: pass `noise` or a `generator`")
    b = x_T.shape[0]
    x = x_T
    for idx in range(params.num_steps):
        with span("ddim.step", index=idx):
            with span("ddim.eval"):
                t_b = torch.full((b,), int(params.ts[idx]),
                                 dtype=torch.int64, device=x.device)
                outs = model_fn(x, t_b)
            with span("ddim.guidance"):
                model_output = _guide(outs, guidance_scale, cfg_img,
                                      guidance_rescale)
            with span("ddim.update"):
                x = _update(x, model_output, params, idx, noise, generator,
                            parameterization)
    return x


def make_cfg_model_fn(apply_model: Callable, cond: torch.Tensor,
                      uncond: Optional[torch.Tensor] = None,
                      uncond_img: Optional[torch.Tensor] = None,
                      batched_cfg: bool = True) -> ModelFn:
    """A ModelFn over all guidance streams. With `batched_cfg` the streams'
    contexts are stacked on the batch axis: one apply_model(x, t, ctx) call
    per step."""
    streams = [("cond", cond)]
    if uncond is not None:
        streams.append(("uncond", uncond))
    if uncond_img is not None:
        streams.append(("uncond_img", uncond_img))
    n = len(streams)

    if not batched_cfg or n == 1:
        def model_fn_seq(x, t_b):
            return {name: apply_model(x, t_b, c) for name, c in streams}
        return model_fn_seq

    stacked = torch.cat([c for _, c in streams], dim=0)

    def model_fn_batched(x, t_b):
        out = apply_model(torch.cat([x] * n, dim=0), torch.cat([t_b] * n),
                          stacked)
        return {name: p for (name, _), p in zip(streams, out.chunk(n, dim=0))}

    return model_fn_batched
