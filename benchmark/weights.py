"""Random weights from the seed, made by the benchmark on the device and
handed alike to the program under test and to the reference.

The rule per parameter (by name, in sorted order of names): the
Resampler's latents N(0, 1/dim); every matrix or kernel N(0, 1/fan_in);
1-D `weight`s (norm scales) 1; other 1-D parameters (biases, the class
embedding) N(0, 0.02^2). The normal draws come from one generator on the
device in a few large calls, in bf16, the dtype the weights are served in;
each parameter's values are its slice times its scale, rounded to bf16.
The reference takes the same bf16 values in float32.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import torch

CHUNK = 1 << 28


def scale_of(name: str, shape) -> float:
    """The standard deviation of a parameter's draw; 0 for a norm scale,
    which is 1."""
    if name.endswith("latents"):
        return shape[-1] ** -0.5
    if len(shape) >= 2:
        return math.prod(shape[1:]) ** -0.5
    if name.rsplit(".", 1)[-1] == "weight":
        return 0.0
    return 0.02


def values(shapes: Dict[str, Tuple[int, ...]], seed: int, device
           ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, bf16 tensor on `device`) for every name of `shapes`, sorted."""
    names = sorted(shapes)
    total = sum(math.prod(shapes[n]) for n in names
                if scale_of(n, shapes[n]))
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(total, dtype=torch.bfloat16, device=device)
    for s in range(0, total, CHUNK):
        flat[s:s + CHUNK] = torch.randn(min(CHUNK, total - s), generator=gen,
                                        device=device, dtype=torch.bfloat16)
    off = 0
    for n in names:
        shape, sc = shapes[n], scale_of(n, shapes[n])
        if not sc:
            yield n, torch.ones(shape, dtype=torch.bfloat16, device=device)
            continue
        k = math.prod(shape)
        yield n, flat[off:off + k].view(shape) * sc
        off += k


@torch.no_grad()
def fill_(module: torch.nn.Module, seed: int) -> None:
    """Overwrite every parameter of `module` with the seed's values, cast to
    the parameter's dtype."""
    params = dict(module.named_parameters())
    device = next(iter(params.values())).device
    shapes = {n: tuple(p.shape) for n, p in params.items()}
    for n, v in values(shapes, seed, device):
        params[n].copy_(v)
