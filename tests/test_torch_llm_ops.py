"""PyTorch port, the ops of the LLM-conditioned slice against the JAX
package on the CPU: rms_norm and rotary_embed; the plain versions of the
multi-block packed attention and dual cross-attention kernels against the
Pallas kernels in interpreter mode; the gates against the JAX gates at every
320x512 and 576x1024 site for head widths 32 to 128; and the UNet's routing
of head widths that do not divide 128, traced with stand-in launchers."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import open_pandora_tpu.ops.dual_cross_attention as jdca
import open_pandora_tpu.ops.packed_attention as jpa
from open_pandora_tpu.models.llama import rotary_embed as jax_rotary
from open_pandora_tpu.ops.norms import rms_norm as jax_rms_norm
from open_pandora_tpu_torch.core import config as tcfg
from open_pandora_tpu_torch.models.llama import rotary_embed
from open_pandora_tpu_torch.ops import kernels
from open_pandora_tpu_torch.ops.dual_cross_attention import (
    dual_cross_attention, dual_cross_attention_eligible,
    dual_cross_attention_plain)
from open_pandora_tpu_torch.ops.fused_temporal import fused_temporal_eligible
from open_pandora_tpu_torch.ops.norms import rms_norm
from open_pandora_tpu_torch.ops.packed_attention import (
    packed_attention_eligible, packed_regime, self_attention_packed)
from test_torch_fused_ops import _meta_eval, _spy_unet
from torch_parity import max_abs

tdca = importlib.import_module(
    "open_pandora_tpu_torch.ops.dual_cross_attention")
F32, BF16 = torch.float32, torch.bfloat16
JD = {F32: jnp.float32, BF16: jnp.bfloat16}


@pytest.fixture
def interpret_pallas(monkeypatch):
    # jpa.pl and jdca.pl are one module
    monkeypatch.setattr(jpa.pl, "pallas_call",
                        functools.partial(jpa.pl.pallas_call, interpret=True))


def _both(a, dtype):
    return torch.from_numpy(a).to(dtype), jnp.asarray(a).astype(JD[dtype])


def _bf16_tol(ref) -> float:
    """Both sides round the output to bf16 once; a last-bit difference of an
    intermediate can move it by one bf16 step: 2^-7 of the largest |value|."""
    return 2.0 ** -7 * float(np.abs(np.asarray(ref, np.float32)).max())


# -- rms_norm, rotary_embed ----------------------------------------------------


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_rms_norm_matches(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 9, 64)) * 3).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    (tx, jx), (tw, jw) = _both(x, dtype), _both(w, dtype)
    ref = jax_rms_norm(jx, jw, eps=1e-6)
    out = rms_norm(tx, tw, eps=1e-6)
    assert out.dtype == dtype
    # fp32: summation order of the mean square only
    tol = 1e-5 if dtype == F32 else _bf16_tol(ref)
    assert max_abs(out.float(), ref.astype(jnp.float32)) <= tol


@pytest.mark.parametrize("positions", ["default", "per_batch", "from_mask"])
def test_rotary_embed_matches(positions):
    rng = np.random.default_rng(1)
    b, n, h, d = 2, 11, 3, 16
    x = rng.standard_normal((b, n, h, d)).astype(np.float32)
    if positions == "default":
        pos = np.arange(n)
    elif positions == "per_batch":
        pos = rng.integers(0, 4000, (b, n))
    else:   # the world model's: cumsum(mask) - 1, pads repeat a position
        mask = np.array([[1, 1, 0, 0, 1, 1, 1, 0, 1, 1, 1],
                         [1] * 11])
        pos = np.cumsum(mask, axis=1) - 1
    ref = jax_rotary(jnp.asarray(x), jnp.asarray(pos, jnp.int32))
    out = rotary_embed(torch.from_numpy(x), torch.from_numpy(pos))
    # fp32 sin/cos of arguments up to 4000: the two libm's differ by ulps
    assert max_abs(out, ref) <= 2e-5
    assert out.shape == (b, n, h, d)


# -- plain versions against the Pallas kernels -----------------------------------


@pytest.mark.parametrize("b,n,m,heads,hd,dtype", [
    (1, 576, 300, 2, 128, F32),     # M neither a block nor a tile multiple
    (1, 512, 384, 5, 320, BF16),    # heads straddle the 128-lane groups
    (2, 520, 700, 3, 96, F32),      # head width 32, ragged N
])
def test_multi_block_packed_plain_matches_pallas(interpret_pallas,
                                                 monkeypatch, b, n, m, heads,
                                                 hd, dtype):
    """`_packed_call_multi` with a small key block, so that several blocks
    run (as tests/test_packed_attention.py shrinks the 9216-token case)."""
    monkeypatch.setattr(jpa, "_MULTI_BLOCK_K", 128)
    monkeypatch.setattr(jpa, "_MAX_KV_ROWS", 128)
    rng = np.random.default_rng(2)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, n, hd), (b, m, hd), (b, m, hd))]
    (tq, jq), (tk, jk), (tv, jv) = (_both(a, dtype) for a in arrs)
    assert not jpa._single_block_fits(n, (m,), heads)
    ref = jpa.self_attention_packed(jq, jk, jv, heads=heads, block_q=256)
    out = self_attention_packed(tq, tk, tv, heads=heads)
    assert out.dtype == dtype and out.shape == (b, n, hd)
    tol = 1e-5 if dtype == F32 else _bf16_tol(ref)
    assert max_abs(out.float(), ref.astype(jnp.float32)) <= tol


@pytest.mark.parametrize("b,n,mt,mi,h,d,dtype,gate", [
    (2, 640, 77, 16, 4, 80, F32, 1.37),     # head width 80, attn2's keys
    (1, 2560, 77, 16, 4, 80, BF16, 1.0),
    (2, 513, 100, 130, 2, 48, F32, 0.25),   # ragged q, both streams padded
    (2, 640, 77, 256, 5, 64, BF16, 0.6),
])
def test_dual_cross_plain_matches_pallas(interpret_pallas, b, n, mt, mi, h, d,
                                         dtype, gate):
    rng = np.random.default_rng(3)
    arrs = [rng.standard_normal((b, rows, h, d)).astype(np.float32)
            for rows in (n, mt, mt, mi, mi)]
    both = [_both(a, dtype) for a in arrs]
    ref = jdca.dual_cross_attention(*[j for _, j in both],
                                    jnp.asarray(gate, jnp.float32))
    out = dual_cross_attention(*[t for t, _ in both], gate)
    assert out.dtype == dtype and out.shape == (b, n, h, d)
    tol = 1e-5 if dtype == F32 else _bf16_tol(ref)
    assert max_abs(out.float(), ref.astype(jnp.float32)) <= tol
    # the wrapper on a CPU tensor is the plain version; a gate held in a
    # tensor (the learnable tanh gate) gives the same
    assert torch.equal(out, dual_cross_attention_plain(
        *[t for t, _ in both], torch.tensor(gate)))


def test_dual_cross_gradients_match_jax():
    """The backward differentiates the plain version, as the JAX custom VJP
    differentiates its XLA twin: q, a key stream and the gate."""
    rng = np.random.default_rng(4)
    arrs = [rng.standard_normal((1, rows, 2, 48)).astype(np.float32)
            for rows in (520, 77, 77, 16, 16)]
    ts = [torch.from_numpy(a).requires_grad_() for a in arrs]
    gate = torch.tensor(0.8, requires_grad=True)
    (dual_cross_attention(*ts, gate) ** 2).sum().backward()

    def loss(q, kt, g):
        js = [jnp.asarray(a) for a in arrs]
        return jnp.sum(jdca.dual_cross_attention_xla(
            q, kt, js[2], js[3], js[4], g) ** 2)
    gq, gkt, gg = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(arrs[0]), jnp.asarray(arrs[1]), jnp.asarray(0.8))
    # fp32, sums over 520 rows: 1e-3 on gradients of magnitude up to ~10
    assert max_abs(ts[0].grad, gq) <= 1e-3
    assert max_abs(ts[1].grad, gkt) <= 1e-3
    assert abs(float(gate.grad) - float(gg)) <= 1e-4 * abs(float(gg))
    assert all(t.grad is not None for t in ts)


# -- gates against the JAX gates -----------------------------------------------

# tokens per spatial level at 320x512 (latent 40x64) and 576x1024 (72x128),
# with the level's channels
LEVELS = [(2560, 320), (640, 640), (160, 1280), (40, 1280),
          (9216, 320), (2304, 640), (576, 1280), (144, 1280)]
HEAD_WIDTHS = (32, 40, 48, 64, 80, 96, 128)


@pytest.mark.parametrize("d", HEAD_WIDTHS)
def test_spatial_gates_match_jax(d):
    """Every attn1 / attn2 site: the packed gate, and where it refuses, the
    dual cross-attention gate, decide as the JAX gates do."""
    for n, ch in LEVELS:
        if ch % d:
            continue
        heads = ch // d
        for ms in ((n,), (77,), (77, 16)):
            assert packed_attention_eligible(n, ms, heads, ch) == \
                jpa.packed_attention_eligible(n, ms, heads, ch), (n, ch, ms)
        assert dual_cross_attention_eligible(n, 77, 16, d) == \
            jdca.dual_cross_attention_eligible(n, 77, 16, d), (n, d)


def test_gates_own_rules():
    """The one rule each port gate adds: a head width the kernels cannot
    read in 32-bit words takes the unfused route by its shape."""
    assert jdca.dual_cross_attention_eligible(2560, 77, 16, 44)
    assert not dual_cross_attention_eligible(2560, 77, 16, 44)
    assert not dual_cross_attention_eligible(160, 77, 16, 80)      # short q
    assert not dual_cross_attention_eligible(2560, 77, 2048, 80)   # long keys
    # the fused temporal kernel's mma tiles: head widths 16, 32 and 64
    assert fused_temporal_eligible(16, 320, 320, heads=5)
    assert not fused_temporal_eligible(16, 320, 320, heads=4)      # width 80
    assert not fused_temporal_eligible(16, 384, 384, heads=8)      # width 48
    assert not fused_temporal_eligible(16, 80, 80, heads=5)        # c % 32
    assert fused_temporal_eligible(16, 320, 320)                   # JAX's half


@pytest.mark.parametrize("n,ms,heads", [
    (2560, (2560,), 5), (640, (640,), 10), (9216, (9216,), 5),
    (2304, (2304,), 10), (576, (576,), 20), (2560, (77, 16), 5),
    (9216, (77, 16), 5), (576, (576,), 40), (2304, (2304,), 5),
    (600, (3000,), 10),
])
def test_packed_regime_matches_jax(n, ms, heads):
    want = "single" if jpa._single_block_fits(n, ms, heads) else "multi"
    assert packed_regime(n, ms, heads) == want
    # the product's one multi-block shape: level 0 at 576x1024
    if (n, ms, heads) == (9216, (9216,), 5):
        assert want == "multi"


# -- routing of the UNet, traced on the meta device --------------------------


@pytest.mark.parametrize("d,height,width", [(80, 320, 512), (48, 320, 512),
                                            (80, 576, 1024)])
def test_odd_head_width_routes_to_dual_cross(monkeypatch, d, height, width):
    """Head widths that do not divide 128: attn2 with n >= 512 takes the
    dual cross-attention kernel, as the JAX route does
    (models/unet3d.py:159-166), attn1 the flash kernel, and the temporal
    sites the small-attention kernel (the fused temporal kernel does not
    serve the width); every site passes its kernel's shape checks."""
    calls = _spy_unet(monkeypatch)
    monkeypatch.setattr(kernels, "fused_available", lambda x: True)
    mc = 320 if d == 80 else 384
    cfg = tcfg.PandoraConfig(unet=tcfg.UNet3DConfig(
        model_channels=mc, num_head_channels=d))
    _meta_eval(cfg.unet, BF16, height, width)
    got = {k: calls.count(k) for k in chip_smoke.KERNEL_KEYS}
    want = chip_smoke.predicted_launches(cfg, height, width, 1,
                                         frame_chunk=8, fused=True)["per_eval"]
    assert got == want
    # the spatial transformers of 512 tokens or more: levels 0 and 1 at
    # 320x512 (10), levels 0 to 2 at 576x1024 (15)
    sites = 10 if height == 320 else 15
    assert got["dual_cross"] == sites and got["flash"] == sites
    assert got["packed"] == got["packed_multi"] == got["fused_temporal"] == 0
    assert got["small"] == 34       # every temporal attention


def test_hires_eval_routes_as_predicted(monkeypatch):
    """PandoraConfig() at 576x1024, bf16 eval on the fused route: level 0's
    attn1 (N = M = 9216) counts as the multi-block regime, 5 per eval."""
    calls = _spy_unet(monkeypatch)
    monkeypatch.setattr(kernels, "fused_available", lambda x: True)
    cfg = tcfg.PandoraConfig()
    _meta_eval(cfg.unet, BF16, 576, 1024)
    got = {k: calls.count(k) for k in chip_smoke.KERNEL_KEYS}
    want = chip_smoke.predicted_launches(cfg, 576, 1024, 1, frame_chunk=2,
                                         fused=True)["per_eval"]
    assert got == want
    assert got["packed_multi"] == 5 and got["dual_cross"] == 0
    assert got["packed"] == 25      # 10 attn1 and 15 attn2 sites
    # the JAX gate sends exactly these to `_kernel_multi`
    assert not jpa._single_block_fits(9216, (9216,), 5)
    assert jpa._single_block_fits(2304, (2304,), 10)


def test_dual_cross_refuses_other_devices():
    x = torch.empty(2, 8, 2, 16, dtype=BF16, device="meta")
    with pytest.raises(ValueError):
        tdca._dual_cuda(x, x, x, x, x, torch.tensor(1.0))
    # on a CUDA-shaped call the head-width rule raises, no silent answer
    with pytest.raises(ValueError):
        tdca.check_shapes(*[torch.empty(2, 8, 2, 44, dtype=BF16)] * 5)
