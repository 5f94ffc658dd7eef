"""PyTorch port, the fused GEGLU feed-forward op (LN + GEGLU + residual):
its plain version and the op (the plain version on a CPU tensor) against
the Pallas kernel (interpreter mode on the CPU) and its XLA twin, in fp32 on
3-D inputs with ragged rows and under the bf16 rule; its gradient against
jax.grad of the JAX op, whose custom VJP differentiates the twin."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import open_pandora_tpu.ops.fused_geglu as fg
from open_pandora_tpu_torch.ops import fused_geglu as tfg
from torch_parity import max_abs


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(fg.pl, "pallas_call",
                        functools.partial(fg.pl.pallas_call, interpret=True))


def _inputs(c, lead, seed=0):
    """x (*lead, c) and the LN, W1, b1, W2, b2 of inner = 4c, as NumPy
    float32 at the JAX tests' scales."""
    rng = np.random.default_rng(seed)
    inner = 4 * c

    def n(*s, scale=1.0, shift=0.0):
        return (shift + scale * rng.standard_normal(s)).astype(np.float32)
    return (n(*lead, c, scale=3.0), n(c, scale=0.1, shift=1.0),
            n(c, scale=0.05), n(c, 2 * inner, scale=c ** -0.5),
            n(2 * inner, scale=0.02), n(inner, c, scale=inner ** -0.5),
            n(c, scale=0.02))


def _twin(args, dtype=jnp.float32):
    x = jnp.asarray(args[0]).astype(dtype)
    rest = [jnp.asarray(a).astype(dtype) for a in args[1:]]
    out = fg.geglu_ff_xla(x.reshape(-1, x.shape[-1]), *rest, eps=1e-5)
    return out.reshape(x.shape)


@pytest.mark.parametrize("c,lead", [(32, (2, 150)), (64, (3, 37)),
                                    (64, (1, 256))])
def test_matches_pallas_and_twin_fp32(c, lead):
    args = _inputs(c, lead)
    pallas = fg.fused_geglu_ff(*[jnp.asarray(a) for a in args])
    twin = _twin(args)
    targs = [torch.from_numpy(a) for a in args]
    op = tfg.fused_geglu_ff(*targs)
    plain = tfg.geglu_ff_plain(targs[0].reshape(-1, c), *targs[1:]
                               ).reshape(targs[0].shape)
    assert op.shape == tuple(lead) + (c,) and op.dtype == torch.float32
    for out in (op, plain):
        np.testing.assert_allclose(out.numpy(), np.asarray(pallas),
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(out.numpy(), np.asarray(twin), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("c,lead", [(32, (2, 150)), (64, (3, 37))])
def test_bf16_rule(c, lead):
    """The op in bf16 within twice the JAX twin's bf16 distance from its
    fp32 result plus 1% of mean |fp32| (the limit taken from the JAX side
    alone), of both the fp32 and the bf16 twin, on bf16-rounded inputs."""
    args = [np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(
        jnp.float32)) for a in _inputs(c, lead, seed=1)]
    jax16 = np.asarray(_twin(args, jnp.bfloat16).astype(jnp.float32))
    jax32 = np.asarray(_twin(args))
    out = tfg.fused_geglu_ff(*[torch.from_numpy(a).bfloat16()
                               for a in args])
    assert out.dtype == torch.bfloat16
    port16 = out.float().numpy()
    limit = 2 * max_abs(jax16, jax32) + 1e-2 * np.abs(jax32).mean()
    assert max_abs(port16, jax32) <= limit
    assert max_abs(port16, jax16) <= limit


@pytest.mark.parametrize("c,lead", [(32, (2, 40)), (64, (1, 33))])
def test_grad_matches_jax(c, lead):
    args = _inputs(c, lead, seed=3)
    ct = np.random.default_rng(4).standard_normal(
        tuple(lead) + (c,)).astype(np.float32)

    def loss(*a):
        return jnp.sum(fg.fused_geglu_ff(*a) * jnp.asarray(ct))
    want = jax.grad(loss, argnums=tuple(range(7)))(
        *[jnp.asarray(a) for a in args])
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    (tfg.fused_geglu_ff(*targs) * torch.from_numpy(ct)).sum().backward()
    for t, w in zip(targs, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)


def test_eligibility_matches_jax_at_the_unet_widths():
    for c in (320, 640, 1280):
        assert tfg.geglu_ff_eligible(c) == fg.geglu_ff_eligible(c) is True
    assert tfg._pick_tiles(320, 1280) == fg._pick_tiles(320, 1280)
    # the card's kernels: multiples of 32, with no upper width of their own
    assert not tfg.geglu_ff_eligible(48)
    assert tfg.geglu_ff_eligible(2560) == fg.geglu_ff_eligible(2560) is True
