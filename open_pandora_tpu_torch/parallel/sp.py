"""Sequence-parallel ring attention over the mesh's data axis.

Counterpart of open_pandora_tpu/parallel/sp.py:40-181 (a capability the
reference lacks, SURVEY.md section 2.7): the sequence axis is split over
the ranks, each rank attends its query shard to a key/value shard that
rotates around the ring (`batch_isend_irecv` to the next rank), and the
partial outputs merge by their log-sum-exp.

Each ring block is one attention call, picked by the device: on the card
the flash kernel with its LSE (ops/flash_attention.py, row 1), causal on
the diagonal block and full on the earlier shards; on the CPU the plain
`_attn_with_lse`. Under a causal mask a later shard's weight is exactly 0
(JAX's finite `_MASKED` fill underflows in the merge), so it is not
computed.

Wiring: inside `sequence_parallel(ms)`, ops.attention routes clean causal
self-attention (LLaMA prefill) through the ring; `sp_llama_prefill` runs
the LLaMA trunk so. The UNet is deliberately not wired (a conv UNet would
need halo exchange around every conv; parallel/sharded_infer.py's stream
and frame split needs no traffic inside the UNet).
"""

from __future__ import annotations

import contextvars
from contextlib import contextmanager
from typing import Optional

import torch
import torch.distributed as dist

from open_pandora_tpu_torch.ops.flash_attention import flash_attention
from open_pandora_tpu_torch.parallel.mesh import MeshSpec

_MASKED = -1e30   # finite: a fully masked row's lse stays finite


def _attn_with_lse(q, k, v, sm_scale: Optional[float] = None, mask=None):
    """(B, N, H, D) x (B, M, H, D) -> (out (B, N, H, D), lse (B, N, H)),
    fp32 softmax statistics; `mask` (N, M) bool, True = attend."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask, s, _MASKED)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhnm,bmhd->bnhd", (p / l).to(v.dtype).float(),
                     v.float()).to(q.dtype)
    return o, (m + torch.log(l))[..., 0].transpose(1, 2)


def _merge(o_a, l_a, o_b, l_b):
    """Online-softmax merge of two attention partials."""
    l_new = torch.logaddexp(l_a, l_b)
    w_a = torch.exp(l_a - l_new)[..., None].to(o_a.dtype)
    w_b = torch.exp(l_b - l_new)[..., None].to(o_b.dtype)
    return o_a * w_a + o_b * w_b, l_new


def _block(q, k, v, sm_scale, diagonal: bool):
    """One ring block: causal on the diagonal, full otherwise."""
    if q.is_cuda:
        o, lse = flash_attention(q, k, v, causal=diagonal, sm_scale=sm_scale,
                                 return_lse=True)
        return o, lse.transpose(1, 2)
    mask = None
    if diagonal:
        n = q.shape[1]
        mask = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
    return _attn_with_lse(q, k, v, sm_scale, mask)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   ms: MeshSpec, sm_scale: Optional[float] = None,
                   causal: bool = False) -> torch.Tensor:
    """Self-attention whose sequence axis is split over the data axis:
    q, k, v (B, N / n, H, D) are this rank's shards (rank r holds rows
    [r N / n, (r + 1) N / n)); returns this rank's rows of the full
    attention (causal: the global-index mask)."""
    n, me, group = ms.n_data, ms.data_rank, ms.data_group
    o, lse = _block(q, k, v, sm_scale, diagonal=causal)
    if n == 1:
        return o
    ranks = [dist.get_global_rank(group, i) for i in range(n)]
    k_c, v_c = k.contiguous(), v.contiguous()
    for step in range(1, n):
        k_n, v_n = torch.empty_like(k_c), torch.empty_like(v_c)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, k_c, ranks[(me + 1) % n], group),
            dist.P2POp(dist.isend, v_c, ranks[(me + 1) % n], group),
            dist.P2POp(dist.irecv, k_n, ranks[(me - 1) % n], group),
            dist.P2POp(dist.irecv, v_n, ranks[(me - 1) % n], group)])
        for req in reqs:
            req.wait()
        k_c, v_c = k_n, v_n
        # after `step` rotations this rank holds the shard of rank me - step
        if causal and (me - step) % n > me:
            continue
        o_i, l_i = _block(q, k_c, v_c, sm_scale, diagonal=False)
        o, lse = _merge(o, lse, o_i, l_i)
    return o


# -- wiring -------------------------------------------------------------------

_SP: contextvars.ContextVar = contextvars.ContextVar("sequence_parallel",
                                                     default=None)


@contextmanager
def sequence_parallel(ms: MeshSpec):
    """Route eligible causal self-attention through the ring while active:
    the tensors attention sees are then this rank's sequence shards."""
    token = _SP.set(ms)
    try:
        yield
    finally:
        _SP.reset(token)


def current_sp() -> Optional[MeshSpec]:
    return _SP.get()


def sp_eligible(q_shape, k_shape, causal: bool, mask) -> bool:
    """Ring-route only clean causal self-attention of at least 8 rows a
    shard (prefill; a decode step has N = 1 and never qualifies)."""
    if current_sp() is None or not causal or mask is not None:
        return False
    return q_shape[1] == k_shape[1] and q_shape[1] >= 8


def sp_llama_prefill(llama, inputs_embeds: torch.Tensor, *,
                     ms: MeshSpec) -> torch.Tensor:
    """The LLaMA trunk's final hidden states (b, n, hidden) with every
    layer's causal self-attention ring-split over the data axis: each rank
    runs its n / n_data rows (global positions), and the rows are
    all-gathered. n must divide by the axis."""
    n_dev, r = ms.n_data, ms.data_rank
    n = inputs_embeds.shape[1]
    if n % n_dev:
        raise ValueError(f"sequence {n} not divisible by the data axis "
                         f"{n_dev}")
    c = n // n_dev
    positions = torch.arange(r * c, (r + 1) * c, device=inputs_embeds.device)
    with sequence_parallel(ms):
        local = llama.trunk(inputs_embeds[:, r * c:(r + 1) * c], positions)
    if ms.data_group is None:
        return local
    parts = [torch.empty_like(local) for _ in range(n_dev)]
    dist.all_gather(parts, local.contiguous(), group=ms.data_group)
    return torch.cat(parts, dim=1)
