"""Synthesis across cards: the DDIM denoise and the VAE decode split over
the mesh's data axis.

Counterpart of open_pandora_tpu/parallel/sharded_infer.py. The reference
scales inference by running independent prompts on separate GPUs
(ddp_wrapper.py + inference.py:276-282; here
parallel.mesh.process_shard_indices); these split ONE synthesis call:

  - UNet denoise: the batched-CFG eval has leading dim b * n_streams (2
    for 2-way CFG, 3 for 3-way, times the clip batch). Each data rank
    evaluates the full UNet on its rows of it, and the eps are
    all-gathered: no traffic inside the UNet, whose kernels run unchanged
    per rank. x_T and the DDIM noise come from the same seeded generator
    on every rank, so every rank carries the whole latent.
  - VAE decode: frames are independent (perframe_ae, model.py:996); each
    rank decodes its frames, and the frames are all-gathered.

Both compute the math of the unsharded calls (tests/test_torch_parallel_*
hold them to it).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from open_pandora_tpu_torch.models.vae import decode_video
from open_pandora_tpu_torch.parallel.mesh import MeshSpec


def _gather(local: torch.Tensor, ms: MeshSpec, dim: int) -> torch.Tensor:
    """The data axis's pieces of a tensor, concatenated along `dim`."""
    if ms.data_group is None:
        return local
    parts = [torch.empty_like(local) for _ in range(ms.n_data)]
    dist.all_gather(parts, local.contiguous(), group=ms.data_group)
    return torch.cat(parts, dim=dim)


def sharded_apply_model(dc, ms: MeshSpec):
    """apply(x, t, ctx, concat, fs) -> eps with the leading (b * n_streams)
    axis split over the data axis; DynamiCrafter.sample's `_apply_model`."""
    n, r = ms.n_data, ms.data_rank

    def apply(x, t, ctx, concat, fs):
        if x.shape[0] % n:
            raise ValueError(
                f"CFG-stream batch {x.shape[0]} not divisible by data "
                f"axis {n}; pick dp in {{1,2,..}} dividing b*n_streams")
        c = x.shape[0] // n
        rows = slice(r * c, (r + 1) * c)
        return _gather(dc.apply_model(x[rows], t[rows], ctx[rows],
                                      concat[rows], fs[rows]), ms, 0)

    return apply


def sharded_synthesis(dc, ms: MeshSpec, **kw) -> torch.Tensor:
    """DynamiCrafter.image_guided_synthesis with the CFG-stream batch split
    over the data axis: the same arguments and result. Every rank passes
    the same arguments and a generator of the same seed."""
    return dc.image_guided_synthesis(_apply_model=sharded_apply_model(dc, ms),
                                     **kw)


def sharded_decode(dc, ms: MeshSpec, z: torch.Tensor,
                   frame_chunk: Optional[int] = None) -> torch.Tensor:
    """DynamiCrafter.decode with the frames split over the data axis.
    z (b, T, hz, wz, 4), T divisible by the axis; each rank decodes its
    frames `frame_chunk` at a time (all of them by default)."""
    n, r = ms.n_data, ms.data_rank
    if z.shape[1] % n:
        raise ValueError(f"temporal length {z.shape[1]} % mesh {n} != 0")
    c = z.shape[1] // n
    local = decode_video(dc.first_stage_model,
                         z[:, r * c:(r + 1) * c].to(dc.dtype),
                         scale_factor=dc.cfg.diffusion.scale_factor,
                         frame_chunk=frame_chunk or c)
    return _gather(local, ms, 1)
