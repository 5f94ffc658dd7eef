"""Dual cross-attention on (B, N, H, D): text and image key/value streams
for the same queries in one kernel (csrc/dual_cross_attn_fwd.cu), its plain
version, its launch plan, and the autograd Function that picks between them
by device.

Counterpart of open_pandora_tpu/ops/dual_cross_attention.py (Pallas
`_kernel`, through `_forward` and `dual_cross_attention`):

    out = attn(q, K_text, V_text) + gate * attn(q, K_img, V_img)

The UNet's attn2 takes it where the packed kernel's gate refuses the shape,
which is any head width that does not divide 128 (40, 48, 80, 96). The
kernel is forward-only and routed in eval; the backward differentiates the
plain version, as the JAX package's custom VJP does, so a stray gradient is
right.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Union

import torch

from open_pandora_tpu_torch.core import flags
from open_pandora_tpu_torch.ops import kernels

LANES = 128
MIN_Q = 512
MAX_KV_ROWS = 512    # per stream, padded to 128

# the card's kernel: 64-row q tiles, key tiles of up to 80 keys, two
# warpgroups a block, one block a multiprocessor; the shared memory a
# block may take
TILE = 64
KEY_TILE = 80
SMEM_LIMIT = 232448

Gate = Union[float, torch.Tensor]


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def dual_cross_attention_eligible(n: int, mt: int, mi: int, d: int) -> bool:
    """The JAX package's shape gate (ops/dual_cross_attention.py:151-159):
    q has at least 512 rows, the head is at most 128 wide, each stream's key
    rows padded to 128 are at most 512. One rule more than the JAX gate:
    the head width is a multiple of 8, since the kernel reads rows in 32-bit
    words and keeps column pairs (no product head is narrower than 40).
    PANDORA_DISABLE_DUALCA refuses every shape, as in JAX."""
    if flags.flag("PANDORA_DISABLE_DUALCA"):
        return False
    return (n >= MIN_Q and d <= 128 and d % 8 == 0
            and _ceil_to(mt, LANES) <= MAX_KV_ROWS
            and _ceil_to(mi, LANES) <= MAX_KV_ROWS)


def dual_cross_attention_plain(q: torch.Tensor, kt: torch.Tensor,
                               vt: torch.Tensor, ki: torch.Tensor,
                               vi: torch.Tensor, gate: Gate) -> torch.Tensor:
    """The kernel's function in plain PyTorch, with its casts: per stream,
    fp32 scores scaled by D ** -0.5, the unnormalised probabilities cast to
    v's dtype for the product with v, the stream normalised in fp32; the
    image stream scaled by the gate in fp32; one cast at the end."""
    scale = q.shape[-1] ** -0.5
    qf = q.float()
    out = None
    for i, (k, v) in enumerate(((kt, vt), (ki, vi))):
        s = torch.einsum("bnhd,bmhd->bhnm", qf, k.float()) * scale
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        l = p.sum(dim=-1)                                    # (b, h, n)
        acc = torch.einsum("bhnm,bmhd->bnhd", p.to(v.dtype).float(),
                           v.float())
        acc = acc / torch.where(l == 0, 1.0, l).permute(0, 2, 1)[..., None]
        if i:
            acc = torch.as_tensor(gate, dtype=torch.float32,
                                  device=q.device) * acc
        out = acc if out is None else out + acc
    return out.to(q.dtype)


class _DualCrossAttention(torch.autograd.Function):
    """The kernel (or its plain version on a CPU tensor) forward; the
    backward differentiates the plain version. The gate is a float or a
    scalar tensor."""

    @staticmethod
    def forward(ctx, q, kt, vt, ki, vi, gate):
        learnable = torch.is_tensor(gate)
        ctx.save_for_backward(q, kt, vt, ki, vi, *([gate] * learnable))
        ctx.gate = None if learnable else gate
        if q.device.type == "cpu":
            return dual_cross_attention_plain(q, kt, vt, ki, vi, gate)
        return _dual_cuda(q, kt, vt, ki, vi, gate)

    @staticmethod
    def backward(ctx, do):
        with torch.enable_grad():
            args = [t.detach().requires_grad_(need) for t, need in
                    zip(ctx.saved_tensors, ctx.needs_input_grad)]
            out = dual_cross_attention_plain(
                *args, *([ctx.gate] * (ctx.gate is not None)))
            wanted = [a for a in args if a.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, do))
        grads = [next(grads) if a.requires_grad else None for a in args]
        return tuple(grads + [None] * (6 - len(grads)))


def dual_cross_attention(q: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor,
                         ki: torch.Tensor, vi: torch.Tensor,
                         gate: Gate = 1.0) -> torch.Tensor:
    """q (B, N, H, D); text k/v (B, Mt, H, D); image k/v (B, Mi, H, D); gate
    a float or a scalar tensor. Returns attn_text + gate * attn_img,
    (B, N, H, D); differentiable in the tensors. A CUDA tensor launches the
    kernel; a CPU tensor takes the plain version."""
    ts = (q, kt, vt, ki, vi, gate)
    if torch.is_grad_enabled() and any(torch.is_tensor(t) and t.requires_grad
                                       for t in ts):
        return _DualCrossAttention.apply(*ts)
    # no gradient wanted (the eval paths): the same forward without the
    # autograd Function's host cost
    if q.device.type == "cpu":
        return dual_cross_attention_plain(*ts)
    return _dual_cuda(*ts)


dual_cross_attention.launches = 0


class LaunchPlan(NamedTuple):
    """How the kernel covers one call: DMAX, its head-width instance (64
    or 128 columns); resident, whether every key tile of both streams stays
    in shared memory (else each warpgroup streams them through a two-slot
    ring); smem, the bytes of shared memory a block takes; tiles_per_block,
    the 64-row q tiles of one (b, h) a block walks (its two warpgroups take
    alternate ones); grid, (blocks per (b, h), H, B)."""
    dmax: int
    resident: bool
    smem: int
    tiles_per_block: int
    grid: tuple


@functools.lru_cache(maxsize=None)
def launch_plan(b: int, n: int, h: int, d: int, mt: int, mi: int,
                sms: int) -> LaunchPlan:
    """The kernel's plan for q (b, n, h, d) against mt text and mi image
    keys on a card of `sms` multiprocessors (the C launcher computes the
    same shared memory from the plan). A block's 256 threads take the
    register file, so one block runs on each multiprocessor, and the q
    tiles are shared out evenly: each of the 2 sms warpgroups takes about
    B H ceil(n / 64) / (2 sms) of them, as a run of consecutive tiles of
    one (b, h), so the keys a block loads serve every tile it walks."""
    dmax = 64 if d <= 64 else 128
    key_tiles = -(-mt // KEY_TILE) + -(-mi // KEY_TILE)

    def smem(slots):        # four q stages and the key slots, K and V each
        return 1024 + (4 * TILE + 2 * slots * KEY_TILE) * 128 * (dmax // 64)
    resident = smem(key_tiles) <= SMEM_LIMIT
    ntiles = -(-n // TILE)
    per_warpgroup = -(-(b * h * ntiles) // (2 * sms))
    tiles = min(2 * per_warpgroup, ntiles)
    return LaunchPlan(dmax, resident, smem(key_tiles if resident else 4),
                      tiles, (-(-ntiles // tiles), h, b))


def check_shapes(q, kt, vt, ki, vi) -> list:
    """What the kernel takes, device aside: bf16 q (B, N, H, D) and two
    streams of k, v (B, M_s, H, D), D a multiple of 8 up to 128, the head dim
    contiguous, rows 16-byte aligned (the kernel copies 16-byte pieces; the
    UNet's views of its projections always are), B and H within a launch
    grid. Returns the batch, row and head strides of the five tensors, in
    the C interface's order."""
    name = "dual_cross_attention"
    ts = (q, kt, vt, ki, vi)
    if any(t.dtype != torch.bfloat16 for t in ts):
        raise ValueError(f"{name}: needs bf16 q, k and v, got "
                         f"{[t.dtype for t in ts]}")
    if q.ndim != 4 or q.shape[1] == 0:
        raise ValueError(f"{name}: bad q shape {tuple(q.shape)}")
    b, _, h, d = q.shape
    if d % 8 or d > 128:
        raise ValueError(f"{name}: head width must be a multiple of 8 up to "
                         f"128, got {d}")
    if b > 65535 or h > 65535:
        raise ValueError(f"{name}: batch and heads must be at most 65535")
    for k, v in ((kt, vt), (ki, vi)):
        if (k.ndim != 4 or v.shape != k.shape or k.shape[0] != b
                or k.shape[2:] != (h, d) or k.shape[1] == 0):
            raise ValueError(f"{name}: bad k/v shapes {tuple(k.shape)}, "
                             f"{tuple(v.shape)} for q {tuple(q.shape)}")
    strides = []
    for t in ts:
        st = t.stride()
        # bf16: 16 bytes are 8 elements
        if st[3] != 1 or t.data_ptr() % 16 or st[0] % 8 or st[1] % 8 \
                or st[2] % 8:
            raise ValueError(f"{name}: rows must be contiguous and 16-byte "
                             f"aligned, got strides {st}")
        strides += st[:3]
    return strides


def _dual_cuda(q, kt, vt, ki, vi, gate):
    ts = (q, kt, vt, ki, vi)
    kernels.check_cuda_tensors("dual_cross_attention", *ts)
    strides = check_shapes(*ts)
    b, n, h, d = q.shape
    plan = launch_plan(b, n, h, d, kt.shape[1], ki.shape[1],
                       kernels.multiprocessors(q.device))
    gate_t = None
    if torch.is_tensor(gate):
        gate_t = gate.detach().to(device=q.device,
                                  dtype=torch.float32).reshape(1)
    o = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = kernels.library().pandora_dual_cross_attn_fwd(
            q.data_ptr(), kt.data_ptr(), vt.data_ptr(), ki.data_ptr(),
            vi.data_ptr(), None if gate_t is None else gate_t.data_ptr(),
            o.data_ptr(), b, n, kt.shape[1], ki.shape[1], h, d,
            plan.tiles_per_block, int(plan.resident), *strides,
            1.0 if gate_t is not None else float(gate), d ** -0.5,
            kernels.DTYPE_CODES[q.dtype], kernels.stream_handle(q))
    kernels.check_cuda(err, "pandora_dual_cross_attn_fwd")
    dual_cross_attention.launches += 1
    return o
