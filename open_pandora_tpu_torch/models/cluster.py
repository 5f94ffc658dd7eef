"""DPC-KNN token clustering with static cluster counts.

Counterpart of open_pandora_tpu/models/cluster.py:
  - image: 3 cascaded clusterings of the 256 CLIP patch tokens to
    64 -> 32 -> 16 centers, concatenated -> 112 tokens;
  - video: per-frame mean features clustered over time into ceil(T/16)
    events; per event, the member frames' level-0/1/2 spatial clusters are
    clustered again to 64/32/16, concatenated over events in first-frame
    order -> 112 * n_events tokens. An event's token set is the full
    (T * level_tokens) grid under a frame-membership mask, so every shape is
    fixed by T alone.

The function is discontinuous (top-k centers, nearest-center assignment), so
it is held to the JAX package index for index:
  - everything runs in fp32 with TF32 matmuls off: the density tie-break is
    `arange(N) * 1e-6` added to a density in (0, 1];
  - `jax.lax.top_k` returns the lowest index first among equal scores (masked
    tokens all score exactly 0) and `torch.topk` promises no order, so the
    centers come from a stable descending sort; `torch.argmin` returns the
    first minimum, as `jnp.argmin` does; the event order is a stable argsort;
  - merging stays a pair of one-hot matmuls (deterministic on a CUDA device,
    which a scatter-add is not).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def _fp32_matmul():
    """TF32 off for the matmuls inside: the clustering decides by gaps of
    1e-6."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _cdist(x: torch.Tensor) -> torch.Tensor:
    """Pairwise euclidean distance over sqrt(C), fp32: (B, N, C) -> (B, N, N)."""
    x = x.float()
    sq = (x * x).sum(dim=-1)
    with _fp32_matmul():
        d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * torch.einsum(
            "bnc,bmc->bnm", x, x)
    return torch.sqrt(d2.clamp_min(0.0)) / (x.shape[-1] ** 0.5)


def _top_indices(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last axis, the lowest
    index first among equals."""
    return torch.sort(score, dim=-1, descending=True, stable=True)[1][..., :k]


def cluster_dpc_knn(x: torch.Tensor, cluster_num: int, k: int = 5,
                    token_mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, N, C) -> (idx_cluster (B, N) in [0, cluster_num), centers
    (B, cluster_num)): kNN local density, distance to the nearest denser
    token, top-k centers by their product, nearest-center assignment, each
    center assigned to itself. Tokens where token_mask is 0 have density 0
    and are far from everything."""
    B, N, _ = x.shape
    dist = _cdist(x)
    tm = None
    if token_mask is not None:
        tm = token_mask > 0
        dist = dist * tm[:, None, :] + (dist.max() + 1.0) * (~tm[:, None, :])

    nearest = torch.topk(dist, k, dim=-1, largest=False)[0]     # (B, N, k)
    density = torch.exp(-(nearest ** 2).mean(dim=-1))
    # strict ordering among equal densities
    density = density + torch.arange(N, dtype=torch.float32,
                                     device=x.device)[None, :] * 1e-6
    if tm is not None:
        density = density * tm

    # distance to the nearest denser token (the largest distance for the peak)
    higher = density[:, None, :] > density[:, :, None]          # (B, N, N)
    dist_max = dist.reshape(B, -1).max(dim=-1)[0][:, None, None]
    d_score = torch.where(higher, dist, dist_max).min(dim=-1)[0]

    centers = _top_indices(d_score * density, cluster_num)      # (B, K)
    to_centers = torch.gather(dist, 1,
                              centers[:, :, None].expand(-1, -1, N))
    idx_cluster = torch.argmin(to_centers, dim=1)               # (B, N)
    own = torch.arange(cluster_num, device=x.device).expand_as(centers)
    return idx_cluster.scatter(1, centers, own), centers


def merge_tokens(x: torch.Tensor, idx_cluster: torch.Tensor,
                 cluster_num: int,
                 token_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted mean of the tokens of each cluster: x (B, N, C) ->
    (B, cluster_num, C) in x's dtype."""
    B, N, _ = x.shape
    if token_weight is None:
        token_weight = torch.ones((B, N), dtype=torch.float32,
                                  device=x.device)
    onehot = F.one_hot(idx_cluster, cluster_num).float()        # (B, N, K)
    w = token_weight.float()
    with _fp32_matmul():
        all_weight = torch.einsum("bnk,bn->bk", onehot, w) + 1e-6
        merged = torch.einsum("bnk,bnc->bkc", onehot,
                              x.float() * w[:, :, None])
    return (merged / all_weight[:, :, None]).to(x.dtype)


def ctm_down(x: torch.Tensor, cluster_num: int, k: int,
             token_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One stage: cluster, then merge. k is clamped when it exceeds the
    cluster count."""
    if k > cluster_num:
        k = min(3, max(cluster_num // 2, 1))
    idx, _ = cluster_dpc_knn(x, cluster_num, k, token_mask)
    w = None if token_mask is None else (token_mask > 0).float()
    return merge_tokens(x, idx, cluster_num, w)


_KS = (5, 3, 3)


def project_image_tokens(feats: torch.Tensor,
                         rates: Sequence[int] = (64, 32, 16)) -> torch.Tensor:
    """Image branch: cascade 256 -> 64 -> 32 -> 16, all three levels
    concatenated -> (B, 112, C)."""
    outs, x = [], feats
    for r, k in zip(rates, _KS):
        x = ctm_down(x, r, k)
        outs.append(x)
    return torch.cat(outs, dim=1)


def project_video_tokens(frame_feats: torch.Tensor,
                         rates: Sequence[int] = (64, 32, 16),
                         temporal_rate: float = 1.0 / 16.0) -> torch.Tensor:
    """Video branch: frame_feats (T, P, C), the frames' patch tokens ->
    (1, 112 * E, C), E = ceil(T * temporal_rate)."""
    T, _, C = frame_feats.shape
    E = max(math.ceil(T * temporal_rate), 1)
    dev = frame_feats.device

    # events: temporal clustering of the per-frame mean features
    k3 = 5 if 5 <= E else min(3, max(E // 2, 1))
    event_idx = cluster_dpc_knn(frame_feats.mean(dim=1)[None], E, k3)[0][0]

    # events in order of their first frame (an event without frames last)
    frames = torch.arange(T, device=dev)
    first_occ = torch.where(
        event_idx[None, :] == torch.arange(E, device=dev)[:, None],
        frames[None, :], T + 1).min(dim=1)[0]                   # (E,)
    event_order = torch.argsort(first_occ, stable=True)

    # per-frame spatial cascades, batched over the frames
    level_feats, x = [], frame_feats
    for r, k in zip(rates, _KS):
        x = ctm_down(x, r, k)
        level_feats.append(x)                                   # (T, r, C)

    # per event: cluster its frames' level-l tokens to rates[l]
    outs = []
    for e in range(E):
        member = event_idx == event_order[e]                    # (T,)
        for lf, r, k in zip(level_feats, rates, _KS):
            mask = member.repeat_interleave(lf.shape[1])[None]  # (1, T*r)
            outs.append(ctm_down(lf.reshape(1, -1, C), r, k,
                                 token_mask=mask))
    return torch.cat(outs, dim=1)
