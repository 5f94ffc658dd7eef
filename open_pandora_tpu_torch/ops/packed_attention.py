"""Packed-layout attention on (B, N, H*D) activations: the CUDA kernel
(csrc/packed_attn_fwd.cu), its plain version, and the wrappers that pick
between them by device.

Counterpart of open_pandora_tpu/ops/packed_attention.py: the Pallas
`_kernel` (one key/value block per stream, through `self_attention_packed`
and `dual_cross_attention_packed`) and `_kernel_multi` (one stream, an
online softmax carried across key/value blocks: the 9216-token self-attention
at 576x1024). On the card one kernel serves both: it walks every stream in
64-key tiles with an online softmax, so the long-key regime is the same code
with more tiles. `packed_regime` says which of the two Pallas kernels a
shape belongs to, and the wrapper counts the launches of each regime under
its own name. The UNet's spatial transformers hand it the projections as
`to_q`, `to_k`, `to_v` write them: no head split, no transpose.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

from open_pandora_tpu_torch.core import flags
from open_pandora_tpu_torch.ops import kernels
from open_pandora_tpu_torch.utils import profiling

LANES = 128
MIN_Q = 512
MAX_KV_ROWS = 2560          # per padded stream, two streams
MAX_KV_ROWS_SINGLE = 16384  # padded, one stream

Gate = Union[float, torch.Tensor]
Streams = Sequence[Tuple[torch.Tensor, torch.Tensor]]


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def packed_attention_eligible(n: int, ms: Sequence[int], heads: int,
                              hd: int) -> bool:
    """The JAX package's shape gate (ops/packed_attention.py:337-359): the
    head width divides the packed width and 128 lanes and is at most 128, q
    has at least 512 rows, each stream's key rows padded to 128 are at most
    2560 with two streams or 16384 with one. The JAX gate also models the
    TPU's scoped-VMEM stack (`_choose_block_q`, `_stack_budget`) to pick a
    q block that compiles; the card has no such limit (the kernel's tiles
    are fixed and its key loop is unbounded), and at every 320x512 and
    576x1024 site the model admits the shapes this gate admits. One rule
    more than the JAX gate: the head width is a multiple of 8, since the
    kernel reads rows in 16-byte pieces (no product head is narrower than
    64). PANDORA_DISABLE_PACKED refuses every shape, as in JAX."""
    if flags.flag("PANDORA_DISABLE_PACKED"):
        return False
    if heads <= 0 or hd % heads:
        return False
    d = hd // heads
    if not (d <= 128 and LANES % d == 0 and d % 8 == 0 and n >= MIN_Q):
        return False
    limit = MAX_KV_ROWS if len(ms) > 1 else MAX_KV_ROWS_SINGLE
    return all(_ceil_to(m, LANES) <= limit for m in ms)


# The JAX package's model of the TPU's scoped-VMEM stack, which decides
# between its two kernels (ops/packed_attention.py:68-97, 331-334): the
# per-head fp32 scores of one q block against a whole stream must fit a
# calibrated budget for the single-block kernel to compile.
_STACK_BUDGET_WHOLE_N = 8.0 * 2**20
_BLOCK_Q_CANDIDATES = (256, 192, 128, 96, 64)


def _stack_budget(heads: int) -> float:
    return (13.2 if heads <= 8 else 9.9) * 2**20


def _choose_block_q(np_: int, heads: int, mps: Sequence[int]):
    def stack(bq):
        return heads * bq * sum(mps) * 4
    if np_ <= 512 and stack(np_) <= min(_STACK_BUDGET_WHOLE_N,
                                        _stack_budget(heads)):
        return np_
    for bq in _BLOCK_Q_CANDIDATES:
        if stack(min(bq, np_)) <= _stack_budget(heads):
            return min(bq, np_)
    return None


def packed_regime(n: int, ms: Sequence[int], heads: int) -> str:
    """Which Pallas kernel the JAX package runs an admitted shape on:
    "single" (`_kernel`: every stream in one key/value block) or "multi"
    (`_kernel_multi`: the online softmax across blocks), by the rule of
    `_single_block_fits`. Used to name the launch count and the rows of the
    kernel table, never to route: the card's kernel is the same."""
    mps = [_ceil_to(m, LANES) for m in ms]
    fits = (all(mp <= MAX_KV_ROWS for mp in mps)
            and _choose_block_q(_ceil_to(n, LANES), heads, mps) is not None)
    return "single" if fits else "multi"


def packed_attention_plain(q: torch.Tensor, streams: Streams, gate: Gate,
                           *, heads: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: per stream, fp32 scores, the
    unnormalised probabilities cast to v's dtype for the product with v,
    the stream normalised in fp32; the second stream scaled by the gate in
    fp32; one cast at the end. Scores are scaled by D ** -0.5."""
    b, n, hd = q.shape
    d = hd // heads
    scale = d ** -0.5
    qh = q.reshape(b, n, heads, d).float()
    out = None
    for i, (k, v) in enumerate(streams):
        s = torch.einsum("bnhd,bmhd->bhnm", qh,
                         k.reshape(b, -1, heads, d).float()) * scale
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        l = p.sum(dim=-1)                                    # (b, h, n)
        acc = torch.einsum("bhnm,bmhd->bnhd", p.to(v.dtype).float(),
                           v.reshape(b, -1, heads, d).float())
        acc = acc / torch.where(l == 0, 1.0, l).permute(0, 2, 1)[..., None]
        if i:
            acc = torch.as_tensor(gate, dtype=torch.float32,
                                  device=q.device) * acc
        out = acc if out is None else out + acc
    return out.reshape(b, n, hd).to(q.dtype)


def packed_attention(q: torch.Tensor, streams: Streams, gate: Gate = 1.0, *,
                     heads: int) -> torch.Tensor:
    """attn(q, k0, v0) [+ gate * attn(q, k1, v1)] on packed q (B, N, H*D)
    and streams [(k, v)] of (B, M_s, H*D) -> (B, N, H*D). A CUDA tensor
    launches the kernel; a CPU tensor takes the plain version."""
    if q.device.type == "cpu":
        return packed_attention_plain(q, streams, gate, heads=heads)
    return _packed_cuda(q, streams, gate, heads=heads)


packed_attention.launches = 0          # launches in the "single" regime


def packed_attention_multi(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, heads: int) -> torch.Tensor:
    """One stream in the long-key ("multi") regime; the same kernel and the
    same wrapper, named so that its launches have a count of their own."""
    return packed_attention(q, [(k, v)], heads=heads)


packed_attention_multi.launches = 0    # launches in the "multi" regime


def self_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, heads: int) -> torch.Tensor:
    """Self or cross attention on packed (B, N, H*D) q and (B, M, H*D)
    k/v. Callers check packed_attention_eligible."""
    return packed_attention(q, [(k, v)], heads=heads)


def dual_cross_attention_packed(q: torch.Tensor, kt: torch.Tensor,
                                vt: torch.Tensor, ki: torch.Tensor,
                                vi: torch.Tensor, gate: Gate, *,
                                heads: int) -> torch.Tensor:
    """attn(q, text kv) + gate * attn(q, image kv) on packed operands, one
    kernel launch."""
    return packed_attention(q, [(kt, vt), (ki, vi)], gate, heads=heads)


def check_shapes(q: torch.Tensor, streams: Streams, heads: int) -> None:
    """What the kernel takes, device aside: q (B, N, H*D) and one or two
    streams of k, v (B, M_s, H*D), all bf16, D a multiple of 8 up to 128,
    rows with a unit last stride and 16-byte alignment (the kernel copies
    rows in 16-byte cp.async pieces), B and H within a launch grid."""
    name = "packed_attention"
    flat = [t for kv in streams for t in kv]
    if any(t.dtype != torch.bfloat16 for t in (q, *flat)):
        raise ValueError(f"{name}: needs bf16 q, k and v, got {q.dtype}/"
                         f"{[t.dtype for t in flat]}")
    if not 1 <= len(streams) <= 2:
        raise ValueError(f"{name}: one or two key/value streams")
    b, n, hd = q.shape if q.ndim == 3 else (0, 0, 0)
    if n == 0 or heads <= 0 or hd % heads:
        raise ValueError(f"{name}: bad q shape {tuple(q.shape)} for {heads} "
                         "heads")
    d = hd // heads
    if d % 8 or d > 128:
        raise ValueError(f"{name}: head width must be a multiple of 8 up to "
                         f"128, got {d}")
    if b > 65535 or heads > 65535:
        raise ValueError(f"{name}: batch and heads must be at most 65535")
    for k, v in streams:
        if (k.ndim != 3 or v.shape != k.shape or k.shape[0] != b
                or k.shape[2] != hd or k.shape[1] == 0):
            raise ValueError(f"{name}: bad k/v shapes {tuple(k.shape)}, "
                             f"{tuple(v.shape)} for q {tuple(q.shape)}")
    for t in (q, *flat):
        kernels.check_aligned(name, t, 16)


def _packed_cuda(q, streams, gate, *, heads):
    kernels.check_cuda_tensors("packed_attention", q,
                               *[t for kv in streams for t in kv])
    check_shapes(q, streams, heads)
    b, n, hd = q.shape
    d = hd // heads
    gate_t = None
    if isinstance(gate, torch.Tensor):
        gate_t = gate.detach().to(device=q.device,
                                  dtype=torch.float32).reshape(1)
    (k0, v0), (k1, v1) = streams[0], streams[-1]
    o = torch.empty((b, n, hd), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = kernels.library().pandora_packed_attn_fwd(
            q.data_ptr(), k0.data_ptr(), v0.data_ptr(), k1.data_ptr(),
            v1.data_ptr(), None if gate_t is None else gate_t.data_ptr(),
            o.data_ptr(), b, n, k0.shape[1], k1.shape[1], heads, d,
            len(streams), *q.stride()[:2], *k0.stride()[:2],
            *v0.stride()[:2], *k1.stride()[:2], *v1.stride()[:2],
            *o.stride()[:2], 1.0 if gate_t is not None else float(gate),
            d ** -0.5, kernels.DTYPE_CODES[q.dtype],
            kernels.stream_handle(q))
    kernels.check_cuda(err, "pandora_packed_attn_fwd")
    ms = [k.shape[1] for k, _ in streams]
    if packed_regime(n, ms, heads) == "multi":
        packed_attention_multi.launches += 1
    else:
        packed_attention.launches += 1
    if profiling.recording():
        profiling.count("packed_attention", (
            b, n, heads, d, tuple(ms), str(q.dtype).removeprefix("torch.")))
    return o
