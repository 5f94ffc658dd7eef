"""PyTorch port, the training ops: the flash and small-attention backward
(the autograd Functions on a CPU tensor, i.e. the plain backward versions)
against the gradients of the JAX package's Pallas kernels (interpreter mode
on the CPU); the plain flash backward against torch.autograd of the plain
forward; the wrappers' device branch keeping gradients; the diffusion loss,
AdamW after the global-norm clip, the cosine schedule, the EMA, the
synthetic dataset and its batcher against the JAX package; the port's own
copy of the CLIP tokenizer."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
import open_pandora_tpu.ops.flash_attention as jfa
import open_pandora_tpu.ops.small_attention as jsa
from open_pandora_tpu.core.config import DiffusionConfig as JaxDiffusionConfig
from open_pandora_tpu.core.config import TrainConfig as JaxTrainConfig
from open_pandora_tpu.data import webvid as jwebvid
from open_pandora_tpu.diffusion.losses import diffusion_loss as jax_loss
from open_pandora_tpu.diffusion.schedule import make_schedule as jax_schedule
from open_pandora_tpu.pipeline.tokenizers import clip_fallback_encode as jtok
from open_pandora_tpu.train.ema import ema_update
from open_pandora_tpu.train.optim import make_optimizer
from open_pandora_tpu_torch.core.config import DiffusionConfig, TrainConfig
from open_pandora_tpu_torch.data import webvid as twebvid
from open_pandora_tpu_torch.diffusion.losses import diffusion_loss
from open_pandora_tpu_torch.diffusion.schedule import make_schedule
from open_pandora_tpu_torch.ops import flash_attention as tfa
from open_pandora_tpu_torch.ops import small_attention as tsa
from open_pandora_tpu_torch.pipeline.tokenizers import clip_fallback_encode
from open_pandora_tpu_torch.train.ema import EMA
from open_pandora_tpu_torch.train.optim import Optimizer, lr_at


@pytest.fixture(autouse=True)
def _interpret_pallas(monkeypatch):
    for mod in (jfa, jsa):
        monkeypatch.setattr(mod.pl, "pallas_call",
                            functools.partial(mod.pl.pallas_call,
                                              interpret=True))


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _port_grads(fn, arrs, g):
    """Gradients of sum(fn(q, k, v) * g) with respect to q, k, v."""
    ts = [torch.from_numpy(a).requires_grad_() for a in arrs]
    (fn(*ts) * torch.from_numpy(g)).sum().backward()
    return [t.grad.numpy() for t in ts]


def _jax_grads(fn, arrs, g):
    _, vjp = jax.vjp(fn, *map(jnp.asarray, arrs))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _close(got, want, rel):
    for a, b in zip(got, want):
        scale = float(np.abs(b).max())
        assert scale > 0
        np.testing.assert_allclose(a, b, atol=rel * scale, rtol=0)


# (b, n, m, h, d, causal). fp32: the two differ in summation order only;
# held to 1e-5 of each gradient's largest entry.
@pytest.mark.parametrize("b,n,m,h,d,causal", [
    (2, 256, 256, 2, 64, False),    # non-causal
    (1, 128, 384, 2, 64, True),     # causal, N < M (suffix alignment)
    (1, 200, 300, 3, 64, False),    # ragged N and M (the kv edge masked)
    (1, 128, 256, 2, 128, True),    # D = 128, the widest the backward takes
    (1, 160, 192, 2, 80, False),    # D = 80: a supported head width
    (1, 150, 200, 2, 72, False),    # D = 72 (D % 16 == 8), ragged M
])
def test_flash_backward_matches_pallas(b, n, m, h, d, causal):
    arrs = _arrays(0, (b, n, h, d), (b, m, h, d), (b, m, h, d))
    (g,) = _arrays(1, (b, n, h, d))
    got = _port_grads(
        lambda q, k, v: tfa.flash_attention(q, k, v, causal=causal), arrs, g)
    want = _jax_grads(
        lambda q, k, v: jfa.flash_attention(q, k, v, causal=causal), arrs, g)
    _close(got, want, 1e-5)


def _jax_bwd(q, k, v, o, lse, do, causal):
    """The Pallas backward kernels (`_bwd`, interpreter mode) on the given
    forward residuals: one q block and one kv block, padded to 128 rows as
    the JAX wrapper pads them."""
    b, n, h, d = q.shape
    m = k.shape[1]
    n_p, m_p = jfa._ceil_to(n, jfa.LANES), jfa._ceil_to(m, jfa.LANES)

    def heads(a, rows):
        a = jnp.swapaxes(jnp.asarray(a), 1, 2)
        return jnp.pad(a, ((0, 0), (0, 0), (0, rows - a.shape[2]), (0, 0)))
    lse = jnp.pad(jnp.asarray(lse), ((0, 0), (0, 0), (0, n_p - n)))
    res = (heads(q, n_p), heads(k, m_p), heads(v, m_p), heads(o, n_p),
           jnp.broadcast_to(lse[..., None], (b, h, n_p, jfa.LANES)))
    grads = jfa._bwd(d ** -0.5, causal, m, m - n if causal else 0, n_p, m_p,
                     res, (heads(do, n_p), None))
    return [np.asarray(jnp.swapaxes(x, 1, 2))[:, :rows]
            for x, rows in zip(grads, (n, m, m))]


# Causal N > M: the first N - M rows see no key. There the two forwards
# differ by design: the Pallas forward spreads such a row over its padded
# key length (M rounded up to its block), the JAX package's XLA attention
# (`mha_xla`) and the port over the M keys. So the backward is held on the
# same residuals, the port's o and LSE; its LSE of such a row is
# kMaskValue, as the Pallas forward's is after rounding.
@pytest.mark.parametrize("b,n,m,h,d", [
    (1, 200, 136, 2, 64),
    (1, 150, 100, 2, 80),
])
def test_flash_backward_no_visible_key_matches_pallas(b, n, m, h, d):
    q, k, v, do = _arrays(6, (b, n, h, d), (b, m, h, d), (b, m, h, d),
                          (b, n, h, d))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = tfa.flash_attention_plain(tq, tk, tv, causal=True)
    assert bool((lse[:, :, :n - m] == tfa.NEG_INF).all())
    got = tfa.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, causal=True)
    want = _jax_bwd(q, k, v, o.numpy(), lse.numpy(), do, True)
    _close([x.numpy() for x in got], want, 1e-5)


@pytest.mark.parametrize("b,n,m,h,d,causal", [
    (2, 70, 90, 3, 16, False),
    (2, 50, 90, 2, 32, True),
    (1, 64, 64, 2, 128, True),
])
def test_flash_plain_backward_is_autograd_of_plain(b, n, m, h, d, causal):
    """Where every row sees a key (N <= M), the plain backward is the
    derivative of the plain forward."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in
               _arrays(2, (b, n, h, d), (b, m, h, d), (b, m, h, d)))
    (g,) = _arrays(3, (b, n, h, d))
    o, lse = tfa.flash_attention_plain(q, k, v, causal=causal)
    (o * torch.from_numpy(g)).sum().backward()
    got = tfa.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                        o.detach(), lse.detach(),
                                        torch.from_numpy(g), causal=causal)
    _close([x.numpy() for x in got], [t.grad.numpy() for t in (q, k, v)],
           1e-5)


# (b, n, m, h, d): the temporal sites' t = 16, a ragged N < M, B*H >= 128
@pytest.mark.parametrize("b,n,m,h,d", [
    (64, 16, 16, 4, 64),
    (130, 7, 16, 1, 32),
    (40, 7, 7, 5, 32),
])
def test_small_backward_matches_pallas(b, n, m, h, d):
    arrs = _arrays(4, (b, n, h, d), (b, m, h, d), (b, m, h, d))
    (g,) = _arrays(5, (b, n, h, d))
    got = _port_grads(tsa.small_attention, arrs, g)
    want = _jax_grads(jsa.small_attention, arrs, g)
    _close(got, want, 1e-5)
    # the wrapper's backward on a CPU tensor is the plain version
    q, k, v = map(torch.from_numpy, arrs)
    plain = tsa.small_attention_bwd_plain(q, k, v, torch.from_numpy(g))
    _close([x.numpy() for x in plain], got, 0.0)


def _bf16(x):
    """x rounded to bf16, back in fp32."""
    return x.to(torch.bfloat16).float()


def _parts(x, n):
    """x as the bf16 operands a product takes: hi = bf16(x) and lo =
    bf16(x - hi) (n = 2), or hi alone (n = 1)."""
    hi = _bf16(x)
    return (hi, _bf16(x - hi)) if n == 2 else (hi,)


def _tc_emulation(q, k, v, do, scale, n_parts):
    """The roundings of the bf16 tensor-core small-attention kernels in
    plain PyTorch: bf16 q, k, v and do (as given); S, dP, the softmax,
    rowsum(dp p) and ds in fp32; p and ds enter their products as
    `n_parts` bf16 parts, each product accumulated in fp32. o, dq, dk, dv
    in fp32, before the rounding of the outputs."""
    q, k, v, do = (t.float() for t in (q, k, v, do))
    p = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", q, k) * scale, -1)
    dp = torch.einsum("bnhd,bmhd->bhnm", do, v)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
    o = sum(torch.einsum("bhnm,bmhd->bnhd", x, v) for x in _parts(p, n_parts))
    dv = sum(torch.einsum("bhnm,bnhd->bmhd", x, do)
             for x in _parts(p, n_parts))
    dq = sum(torch.einsum("bhnm,bmhd->bnhd", x, k)
             for x in _parts(ds, n_parts))
    dk = sum(torch.einsum("bhnm,bnhd->bmhd", x, q)
             for x in _parts(ds, n_parts))
    return o, dq, dk, dv


# the main path's head widths (64; 80 and 48 at other widths; 72, whose
# k16 tail the kernels zero-fill) at t = 16, a small batch
@pytest.mark.parametrize("d", [64, 80, 48, 72])
def test_small_attention_split_operands_hold_the_bound(d):
    """Why the kernels feed p and ds to the tensor cores as bf16 hi + lo:
    with the split, o, dq, dk and dv (rounded to bf16 as the kernels store
    them) stay within chip_smoke's bound rule against the fp32 plain
    versions on the same bf16 inputs; the same products with p and ds
    rounded once to bf16 come no closer."""
    b, n, h = 24, 16, 4
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in _arrays(
        7, (b, n, h, d), (b, n, h, d), (b, n, h, d), (b, n, h, d)))
    scale = d ** -0.5
    ref32 = (tsa.small_attention_plain(q.float(), k.float(), v.float()),
             *tsa.small_attention_bwd_plain(q.float(), k.float(), v.float(),
                                            do.float()))
    plain = (tsa.small_attention_plain(q, k, v),
             *tsa.small_attention_bwd_plain(q, k, v, do))
    split = _tc_emulation(q, k, v, do, scale, 2)
    single = _tc_emulation(q, k, v, do, scale, 1)
    for name, r, pl, x2, x1 in zip(("o", "dq", "dk", "dv"), ref32, plain,
                                   split, single):
        err, bound = chip_smoke._kernel_bound(_bf16(x2), pl, r)
        assert err <= bound, (name, err, bound)
        assert (x1 - r).abs().max() >= (x2 - r).abs().max(), name


def _tf32(x):
    """cvt.rna.tf32.f32: x's fp32 mantissa rounded to 10 bits, to nearest
    with ties away from zero (the sign bit stays apart from the magnitude
    the carry runs through)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_product(eq, a, b, n_parts):
    """einsum(eq, a, b) as the fp32 flash kernels run it on the tensor
    cores: each operand x = hi + lo (hi = tf32(x), lo = tf32(x - hi)), the
    sum lo_a hi_b + hi_a lo_b + hi_a hi_b accumulated in fp32 (each TF32
    product is exact in fp32); n_parts = 1: hi_a hi_b alone, one TF32
    pass."""
    ah, bh = _tf32(a), _tf32(b)
    if n_parts == 1:
        return torch.einsum(eq, ah, bh)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def _tf32_emulation(q, k, v, do, o, lse, scale, causal, n_parts):
    """The fp32 flash kernels' arithmetic in plain PyTorch: every product
    (S, P v; S, dP, dV, dK, dQ) by `_tf32_product`, the softmax and ds in
    fp32; the backward from the plain forward's o and LSE, as chip_smoke
    phase 3 feeds it. Returns o, dq, dk, dv."""
    def scores():
        s = _tf32_product("bnhd,bmhd->bhnm", q, k, n_parts) * scale
        if causal:
            s = torch.where(tfa.causal_mask(s.shape[-2], s.shape[-1],
                                            s.device), s, tfa.MASK_VALUE)
        return s

    s = scores()
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    o_k = (_tf32_product("bhnm,bmhd->bnhd", p, v, n_parts)
           / p.sum(-1, keepdim=True).permute(0, 2, 1, 3))
    p = torch.exp(scores() - lse[..., None])
    dp = _tf32_product("bnhd,bmhd->bhnm", do, v, n_parts)
    ds = p * (dp - tfa._row_dot(o, do)[..., None]) * scale
    return (o_k, _tf32_product("bhnm,bmhd->bnhd", ds, k, n_parts),
            _tf32_product("bhnm,bnhd->bmhd", ds, q, n_parts),
            _tf32_product("bhnm,bnhd->bmhd", p, do, n_parts))


# (b, n, m, h, d, causal): the head widths of the fp32 kernels' two tile
# sizes (32, 64 in the D <= 64 tile, 128), causal N < M and N > M with a
# ragged M
@pytest.mark.parametrize("b,n,m,h,d,causal", [
    (2, 128, 128, 2, 32, False),
    (2, 128, 128, 2, 64, False),
    (1, 128, 128, 2, 128, False),
    (1, 96, 130, 2, 64, True),
    (1, 130, 96, 2, 128, True),
])
def test_split_tf32_holds_the_ref64_rule(b, n, m, h, d, causal):
    """Why the fp32 flash kernels run every product as three TF32 products:
    so emulated, o, dq, dk and dv stay within chip_smoke's fp32 rule
    (max|x - ref64| <= 8 max|ref32 - ref64|, ref64 the plain version in
    float64 on the same inputs) and the LSE within 1e-3; one TF32 pass
    breaks the rule for every one of them."""
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(
        11, (b, n, h, d), (b, m, h, d), (b, m, h, d), (b, n, h, d)))
    scale = d ** -0.5
    o, lse = tfa.flash_attention_plain(q, k, v, causal=causal)
    ref32 = (o, *tfa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                               causal=causal))
    q64, k64, v64, do64, o64, lse64 = (t.double()
                                       for t in (q, k, v, do, o, lse))
    ref64 = (tfa.flash_attention_plain(q64, k64, v64, causal=causal)[0],
             *tfa.flash_attention_bwd_plain(q64, k64, v64, o64, lse64, do64,
                                            causal=causal))
    split = _tf32_emulation(q, k, v, do, o, lse, scale, causal, 2)
    single = _tf32_emulation(q, k, v, do, o, lse, scale, causal, 1)
    for name, r32, r64, x3, x1 in zip(("o", "dq", "dk", "dv"), ref32, ref64,
                                      split, single):
        err, bound = chip_smoke._ref64_bound(x3, r32, r64)
        assert err <= bound, (name, err, bound)
        err1, _ = chip_smoke._ref64_bound(x1, r32, r64)
        assert err1 > bound, (name, err1, bound)
    lse_k = torch.logsumexp(_tf32_product(
        "bnhd,bmhd->bhnm", q, k, 2) * scale + torch.where(
            tfa.causal_mask(n, m, q.device), 0.0, tfa.MASK_VALUE)
        if causal else _tf32_product("bnhd,bmhd->bhnm", q, k, 2) * scale,
        -1)
    assert (lse_k - lse).abs().max() <= 1e-3


def test_device_branch_keeps_gradients(monkeypatch):
    """On a tensor off the CPU the wrappers launch their kernels, whose
    outputs carry no graph of their own; gradients must still reach q, k
    and v, through the backward kernels. Stand-in launchers on meta tensors
    record the launches."""
    launched = []

    def fwd(name, n_out):
        def launch(q, k, v, **kw):
            launched.append(name)
            o = torch.empty_like(q)
            return (o, torch.empty(q.shape[0], q.shape[2], q.shape[1],
                                   device=q.device)) if n_out == 2 else o
        return launch

    def bwd(name):
        def launch(q, k, v, *rest, **kw):
            launched.append(name)
            return torch.empty_like(q), torch.empty_like(k), \
                torch.empty_like(v)
        return launch

    monkeypatch.setattr(tfa, "_flash_cuda", fwd("flash", 2))
    monkeypatch.setattr(tfa, "_flash_bwd_cuda", bwd("flash_bwd"))
    monkeypatch.setattr(tsa, "_small_cuda", fwd("small", 1))
    monkeypatch.setattr(tsa, "_small_bwd_cuda", bwd("small_bwd"))
    for fn, name in ((tfa.flash_attention, "flash"),
                     (tsa.small_attention, "small")):
        q, k, v = (torch.empty(4, 16, 2, 32, device="meta",
                               requires_grad=True) for _ in range(3))
        fn(q, k, v).sum().backward()
        assert all(t.grad is not None and t.grad.shape == t.shape
                   for t in (q, k, v)), name
        assert launched[-2:] == [name, f"{name}_bwd"]


def _schedules():
    return make_schedule(DiffusionConfig()), jax_schedule(
        JaxDiffusionConfig())


def test_diffusion_loss_matches_jax():
    """Injected timesteps and noise: the JAX draws of `diffusion_loss`
    (losses.py:46-52) handed to the port. The model is a fixed nonlinear
    function of x_noisy and t on both sides."""
    sched, jsched = _schedules()
    (x,) = _arrays(6, (3, 4, 8, 8, 4))
    key = jax.random.PRNGKey(7)
    t_key, n_key = jax.random.split(key)
    t = jax.random.randint(t_key, (3,), 0, 1000)
    noise = jax.random.normal(n_key, x.shape)

    def jmodel(xn, tt, _):
        return jnp.tanh(xn) * (tt[:, None, None, None, None] / 1000.0)

    def tmodel(xn, tt):
        return torch.tanh(xn) * (tt[:, None, None, None, None] / 1000.0)

    want, wm = jax_loss(jmodel, jsched, jnp.asarray(x), None, key)
    got, gm = diffusion_loss(tmodel, sched, torch.from_numpy(x),
                             t=torch.from_numpy(np.asarray(t)),
                             noise=torch.from_numpy(np.asarray(noise)))
    assert abs(float(got) - float(want)) < 1e-6 * float(want)
    assert abs(float(gm["loss_simple"]) - float(wm["loss_simple"])) < \
        1e-6 * float(want)
    # drawn from a generator, the shapes and the range of t hold
    g = torch.Generator().manual_seed(0)
    loss, _ = diffusion_loss(tmodel, sched, torch.from_numpy(x), generator=g)
    assert torch.isfinite(loss)


def _tree(seed):
    a, b = _arrays(seed, (5, 7), (11,))
    return {"a": a, "b": b}


@pytest.mark.parametrize("schedule,clip", [
    ("constant", 0.5),    # the norm is above the clip: scaled
    ("cosine", 100.0),    # below it: untouched
])
def test_adamw_clip_matches_optax(schedule, clip):
    """Three updates of the clipped AdamW against optax's chain on the same
    gradients; fp32, to rounding."""
    kw = dict(learning_rate=1e-2, min_lr=1e-4, lr_schedule=schedule,
              max_steps=4, grad_clip_norm=clip, weight_decay=0.05)
    tx = make_optimizer(JaxTrainConfig(**kw))
    jparams = jax.tree_util.tree_map(jnp.asarray, _tree(8))
    opt_state = tx.init(jparams)
    params = {k: torch.from_numpy(v.copy()).requires_grad_()
              for k, v in _tree(8).items()}
    opt = Optimizer(params, TrainConfig(**kw))
    for i in range(3):
        grads = _tree(20 + i)
        updates, opt_state = tx.update(
            jax.tree_util.tree_map(jnp.asarray, grads), opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in params.items():
            p.grad = torch.from_numpy(grads[k].copy())
        norm = opt.step()
        assert abs(float(norm) - float(optax.global_norm(grads))) < 1e-6
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), jparams[k],
                                       atol=1e-6, rtol=0)


def test_cosine_schedule_matches_optax():
    cfg = TrainConfig(learning_rate=1e-3, min_lr=1e-5, lr_schedule="cosine",
                      max_steps=10)
    sched = optax.cosine_decay_schedule(1e-3, 10, alpha=1e-2)
    for n in (0, 1, 5, 9, 10, 15):
        assert abs(lr_at(cfg, n) - float(sched(n))) < 1e-9


def test_ema_matches_jax():
    params = _tree(9)
    shadow = jax.tree_util.tree_map(jnp.asarray, params)
    ema = EMA({k: torch.from_numpy(v) for k, v in params.items()})
    for step in range(4):
        new = _tree(30 + step)
        shadow = ema_update(shadow, jax.tree_util.tree_map(jnp.asarray, new),
                            jnp.asarray(step), decay=0.9)
        ema.update({k: torch.from_numpy(v) for k, v in new.items()}, step,
                   decay=0.9)
    for k, s in ema.shadow.items():
        assert s.dtype == torch.float32
        np.testing.assert_allclose(s.numpy(), shadow[k], atol=1e-7, rtol=0)


@pytest.mark.parametrize("text,n", [("a red car drives", 77),
                                    ("one two three four five six", 5)])
def test_clip_fallback_tokenizer_matches_jax(text, n):
    assert clip_fallback_encode(text, n) == jtok(text, n)


def test_synthetic_batches_match_jax(monkeypatch):
    """The same seeded samples, epoch orders and collated batches (the
    remainder dropped) as the JAX package's loader on one host."""
    kw = dict(video_length=2, resolution=(8, 12), clip_size=4)
    monkeypatch.setattr(twebvid.SyntheticVideoDataset, "length", 5)
    monkeypatch.setattr(twebvid.SyntheticVideoDataset, "seed", 3)
    ours = twebvid.PrefetchLoader(twebvid.SyntheticVideoDataset(**kw), 2,
                                  text_len=9)
    theirs = jwebvid.PrefetchLoader(
        jwebvid.SyntheticVideoDataset(**kw, length=5, seed=3), 2, text_len=9)
    for epoch in (0, 1):
        got, want = list(ours.epoch(epoch)), list(theirs.epoch(epoch))
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
