"""PyTorch port, attention ops: the plain versions of the two CUDA kernels
against the JAX package's Pallas kernels (interpreter mode on the CPU), the
dispatcher's routing against ops/attention.py, and the package's freedom
from JAX."""

import functools
import importlib
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import open_pandora_tpu.ops.flash_attention as jfa
import open_pandora_tpu.ops.small_attention as jsa
from open_pandora_tpu_torch.ops.attention import attention, attention_route
from open_pandora_tpu_torch.ops.attention_xla import mha
from open_pandora_tpu_torch.ops.flash_attention import (flash_attention,
                                                        flash_attention_plain)
from open_pandora_tpu_torch.ops.small_attention import (small_attention,
                                                        small_attention_plain)

REPO = Path(__file__).resolve().parent.parent
# the module, not the function that open_pandora_tpu.ops re-exports
jattn = importlib.import_module("open_pandora_tpu.ops.attention")


@pytest.fixture(autouse=True)
def _interpret_pallas(monkeypatch):
    for mod in (jfa, jsa):
        monkeypatch.setattr(mod.pl, "pallas_call",
                            functools.partial(mod.pl.pallas_call,
                                              interpret=True))


def _qkv(seed, b, n, m, h, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, n, h, d), (b, m, h, d), (b, m, h, d)))


def _both(arrs, dtype):
    jd = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    return ([torch.from_numpy(a).to(dtype) for a in arrs],
            [jnp.asarray(a).astype(jd) for a in arrs])


# (b, n, m, h, d, causal, dtype, tol): fp32 agrees to accumulation order;
# bf16 to one rounding of p and of o (bf16 eps 2^-8 on O(1) values)
@pytest.mark.parametrize("b,n,m,h,d,causal,dtype,tol", [
    (2, 256, 256, 2, 64, False, torch.float32, 2e-5),    # non-causal
    (1, 128, 384, 2, 64, True, torch.float32, 2e-5),     # causal, N < M
    (1, 200, 300, 3, 64, False, torch.float32, 2e-5),    # ragged N and M
    (1, 256, 256, 1, 512, False, torch.float32, 2e-5),   # VAE: 1 head, D=512
    (2, 256, 256, 2, 64, False, torch.bfloat16, 3e-2),
])
def test_flash_plain_matches_pallas(b, n, m, h, d, causal, dtype, tol):
    (tq, tk, tv), (jq, jk, jv) = _both(_qkv(0, b, n, m, h, d), dtype)
    ref = jfa.flash_attention(jq, jk, jv, causal=causal)
    out, lse = flash_attention_plain(tq, tk, tv, causal=causal)
    assert out.dtype == dtype and lse.shape == (b, h, n)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=tol, rtol=0)
    # the wrapper on a CPU tensor is the plain version
    assert torch.equal(flash_attention(tq, tk, tv, causal=causal), out)


def test_flash_lse_is_logsumexp():
    tq, tk, tv = (torch.from_numpy(a) for a in _qkv(1, 1, 64, 96, 2, 32))
    _, lse = flash_attention_plain(tq, tk, tv, causal=True)
    s = torch.einsum("bnhd,bmhd->bhnm", tq, tk) * 32 ** -0.5
    row = torch.arange(64)[:, None]
    s = s.masked_fill(torch.arange(96)[None] > row + 32, float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, dim=-1), atol=1e-5,
                               rtol=1e-6)


# B*H >= 128, the dispatcher's gate; fp32 to accumulation order, bf16 to
# the output's rounding
@pytest.mark.parametrize("b,n,m,h,d,dtype,tol", [
    (64, 16, 16, 4, 64, torch.float32, 1e-5),
    (40, 16, 16, 5, 64, torch.bfloat16, 2e-2),
    (130, 7, 16, 1, 32, torch.float32, 1e-5),
])
def test_small_plain_matches_pallas(b, n, m, h, d, dtype, tol):
    (tq, tk, tv), (jq, jk, jv) = _both(_qkv(2, b, n, m, h, d), dtype)
    ref = jsa.small_attention(jq, jk, jv)
    out = small_attention_plain(tq, tk, tv)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=tol, rtol=0)
    assert torch.equal(small_attention(tq, tk, tv), out)


def test_plain_mha_matches_jax():
    from open_pandora_tpu.ops.attention_xla import mha_xla
    arrs = _qkv(3, 2, 20, 20, 2, 16)
    mask = np.random.default_rng(4).random((2, 1, 20, 20)) > 0.3
    (tq, tk, tv), (jq, jk, jv) = _both(arrs, torch.float32)
    for kw in ({}, {"causal": True}):
        np.testing.assert_allclose(mha(tq, tk, tv, **kw).numpy(),
                                   np.asarray(mha_xla(jq, jk, jv, **kw)),
                                   atol=1e-6)
    np.testing.assert_allclose(
        mha(tq, tk, tv, mask=torch.from_numpy(mask)).numpy(),
        np.asarray(mha_xla(jq, jk, jv, mask=jnp.asarray(mask))), atol=1e-6)


def _jax_route(monkeypatch, q_shape, k_shape, causal, masked):
    """The route ops/attention.py takes on the TPU, traced abstractly."""
    taken = []
    monkeypatch.setattr(jattn, "_on_tpu", lambda: True)
    for name, route in (("flash_attention", "flash"),
                        ("small_attention", "small"), ("mha_xla", "plain")):
        def rec(q, k, v, *, route=route, **kw):
            taken.append(route)
            return q
        monkeypatch.setattr(jattn, name, rec)
    mask = (jax.ShapeDtypeStruct((1, 1, q_shape[1], k_shape[1]), jnp.bool_)
            if masked else None)

    def f(q, k, m):
        return jattn.attention(q, k, k, causal=causal, mask=m)

    jax.eval_shape(f, jax.ShapeDtypeStruct(q_shape, jnp.bfloat16),
                   jax.ShapeDtypeStruct(k_shape, jnp.bfloat16), mask)
    return taken[0]


@pytest.mark.parametrize("q_shape,k_shape,causal,masked", [
    ((32, 2560, 5, 64), (32, 2560, 5, 64), False, False),   # UNet attn1
    ((32, 640, 10, 64), (32, 640, 10, 64), False, False),
    ((32, 160, 20, 64), (32, 160, 20, 64), False, False),   # below the gate
    ((32, 2560, 5, 64), (32, 77, 5, 64), False, False),     # attn2 text
    ((32, 2560, 5, 64), (32, 16, 5, 64), False, False),     # attn2 image
    ((1, 2560, 1, 512), (1, 2560, 1, 512), False, False),   # VAE mid
    ((5120, 16, 5, 64), (5120, 16, 5, 64), False, False),   # temporal
    ((80, 16, 20, 64), (80, 16, 20, 64), False, False),
    ((4, 16, 5, 64), (4, 16, 5, 64), False, False),         # B*H < 128
    ((5120, 16, 5, 64), (5120, 16, 5, 64), True, False),    # causal temporal
    ((2, 77, 16, 64), (2, 77, 16, 64), True, False),        # CLIP text
    ((1, 1024, 4, 128), (1, 1024, 4, 128), True, False),    # causal prefill
    ((1, 1024, 4, 128), (1, 1024, 4, 128), False, True),    # masked
    ((2, 256, 12, 64), (2, 513, 12, 64), False, False),     # Resampler
])
def test_routing_matches_jax(monkeypatch, q_shape, k_shape, causal, masked):
    expect = _jax_route(monkeypatch, q_shape, k_shape, causal, masked)
    assert attention_route(q_shape, k_shape, causal=causal, masked=masked,
                           on_device=True) == expect
    # a CPU tensor always takes the plain route, as JAX on the CPU does
    assert attention_route(q_shape, k_shape, causal=causal, masked=masked,
                           on_device=False) == "plain"


def test_dispatcher_on_cpu_is_plain_attention():
    tq, tk, tv = (torch.from_numpy(a) for a in _qkv(5, 1, 600, 600, 1, 32))
    assert torch.equal(attention(tq, tk, tv), mha(tq, tk, tv))


def test_wrappers_refuse_other_devices():
    q = torch.empty(2, 16, 64, 8, device="meta")
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
    with pytest.raises(ValueError):
        small_attention(q, q, q)


def test_port_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['flax'] = None; sys.modules['optax'] = None; "
            "import open_pandora_tpu_torch.eval.inference; "
            "import open_pandora_tpu_torch.core.convert; "
            "import open_pandora_tpu_torch.train.trainer; "
            "import open_pandora_tpu_torch.train.step; "
            "import open_pandora_tpu_torch.core.checkpoint; "
            "import open_pandora_tpu_torch.data.webvid; "
            "import open_pandora_tpu_torch.utils.loggers; "
            "import open_pandora_tpu_torch.pipeline.tokenizers; "
            "assert not [m for m in sys.modules if sys.modules[m] is not None"
            " and m.split('.')[0] in ('jax', 'open_pandora_tpu')]")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
