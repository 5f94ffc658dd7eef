"""PyTorch port, weight-only LLaMA quantization against the JAX package
(models/quant.py; small sizes, fp32, CPU): int8 and NF4 codes, scales and
absmax bit for bit (zero columns, exact half-steps and codebook midpoints
built on purpose), the quantized projections, the quantized tiny LLaMA
with and without LoRA, the in-place quantization of a built model, and
the int8 and NF4 layouts under 2-way tensor parallelism in a gloo group
of 2 CPU ranks (tests/torch_parallel_workers.run_group, which imports
this module in each rank for `quant_tp_group`)."""

import threading
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_pandora_tpu.core import convert as jconvert
from open_pandora_tpu.models import llama as jllama
from open_pandora_tpu.models import quant as jquant
from open_pandora_tpu_torch.core import config as tcfg
from open_pandora_tpu_torch.core.convert import llama as llama_from_jax
from open_pandora_tpu_torch.models import lora as tlora
from open_pandora_tpu_torch.models import quant as tquant
from open_pandora_tpu_torch.models.llama import LlamaForCausalLM
import torch_parallel_workers as W
from torch_parity import jax_sub_config, max_abs, rerandomize_

# 4 heads and an MLP of 128: every input width (64, 128) is whole NF4
# blocks, and 2-way TP splits o_proj's input to 32 columns (half a block)
LLAMA = tcfg.LLaMAConfig(vocab_size=97, hidden_size=64, intermediate_size=128,
                         num_layers=2, num_heads=4)
LORA = tcfg.LLaMAConfig(**{**LLAMA.__dict__, "lora_rank": 4})
# tests/test_tp.py's tolerance for a quantized LLaMA's logits
TOL = 2e-4
MODES = ("int8", "nf4")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _int8_weight(rng):
    """(in, out) = (64, 48): a zero column, a column whose largest |w| is
    127 (scale exactly 1) holding exact half-steps, random columns."""
    w = rng.standard_normal((64, 48)).astype(np.float32)
    w[:, 3] = 0.0
    w[:, 5] = rng.integers(-40, 40, 64) + 0.5
    w[0, 5] = -127.0
    return w


def _nf4_weight(rng):
    """(in, out) = (192, 24): a zero block, a ragged tail block (in not a
    multiple of 64 for one case), codebook entries and the midpoints
    between neighbours in a block whose absmax is 1."""
    w = rng.standard_normal((192, 24)).astype(np.float32)
    w[64:128, 2] = 0.0
    code = np.asarray(jquant.NF4_CODE)
    mids = (code[1:] + code[:-1]) / 2
    w[:16, 7] = code
    w[16:31, 7] = mids
    w[31:64, 7] = 0.25
    w[63, 7] = 1.0
    return w


def test_int8_codes_match_jax():
    w = _int8_weight(np.random.default_rng(0))
    ref = jquant.quantize_kernel(w)
    q, scale = tquant.quantize_kernel(torch.from_numpy(w.T.copy()))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), ref["kernel_q"].T)
    np.testing.assert_array_equal(scale.numpy(), ref["scale"])
    assert scale[3] == 1.0 and scale[5] == 1.0
    # half-steps round to even, as numpy does
    assert set(np.abs(q[5].numpy()[1:]) % 2) == {0}
    # a bf16 weight quantizes as its exact fp32 upcast does
    wb = torch.from_numpy(w.T.copy()).to(torch.bfloat16)
    qb, sb = tquant.quantize_kernel(wb)
    q32, s32 = tquant.quantize_kernel(wb.float())
    assert torch.equal(qb, q32) and torch.equal(sb, s32)


@pytest.mark.parametrize("n_in", [192, 170])
def test_nf4_codes_match_jax(n_in):
    w = _nf4_weight(np.random.default_rng(1))[:n_in]
    ref = jquant.quantize_kernel_nf4(w)
    packed, absmax = tquant.quantize_kernel_nf4(torch.from_numpy(w.T.copy()))
    assert packed.dtype == torch.uint8 and absmax.dtype == torch.float32
    assert packed.shape == (24, n_in // 2)
    np.testing.assert_array_equal(packed.numpy(), ref["kernel_p"].T)
    np.testing.assert_array_equal(absmax.numpy(), ref["absmax"].T)
    assert absmax[2, 1] == 1.0                        # the zero block


@pytest.mark.parametrize("mode", MODES)
def test_dequantize_matches_jax(mode):
    rng = np.random.default_rng(2)
    if mode == "int8":
        w = _int8_weight(rng)
        leaves = jquant.quantize_kernel(w)
        ref = jquant.dequantize_kernel(leaves["kernel_q"], leaves["scale"],
                                       dtype=jnp.float32)
        got = tquant.dequantize_kernel(
            *tquant.quantize_kernel(torch.from_numpy(w.T.copy())),
            dtype=torch.float32)
    else:
        w = _nf4_weight(rng)
        leaves = jquant.quantize_kernel_nf4(w)
        ref = jquant.dequantize_kernel_nf4(leaves["kernel_p"],
                                           leaves["absmax"],
                                           dtype=jnp.float32)
        got = tquant.dequantize_kernel_nf4(
            *tquant.quantize_kernel_nf4(torch.from_numpy(w.T.copy())),
            dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref).T)


@pytest.mark.parametrize("mode", MODES)
def test_projection_matches_jax(mode):
    """Int8Linear / NF4Linear against Int8Dense / Int4Dense on the same
    codes, fp32."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((128, 40)).astype(np.float32) / 8
    x = rng.standard_normal((2, 5, 128)).astype(np.float32)
    if mode == "int8":
        jmod, tmod = jllama.Int8Dense(40, dtype=jnp.float32), \
            tquant.Int8Linear(128, 40)
        leaves = jquant.quantize_kernel(w)
    else:
        jmod, tmod = jllama.Int4Dense(40, dtype=jnp.float32), \
            tquant.NF4Linear(128, 40)
        leaves = jquant.quantize_kernel_nf4(w)
    ref = jmod.apply({"params": jax.tree_util.tree_map(jnp.asarray, leaves)},
                     jnp.asarray(x))
    tmod.set_weight_(torch.from_numpy(w.T.copy()))
    with torch.no_grad():
        out = tmod(torch.from_numpy(x))
    assert max_abs(out, ref) <= 1e-5


def _jax_llama_params(cfg, seed):
    """JAX float LLaMA params of `cfg` (LoRA ignored), seeded NumPy
    values through the JAX converter."""
    plain = tcfg.LLaMAConfig(**{**cfg.__dict__, "lora_rank": 0})
    flat = rerandomize_(LlamaForCausalLM(plain), seed=seed)
    return jconvert.convert_llama(flat, cfg.num_layers)


def _jax_quantized(params, mode, lora_rank, rng):
    """JAX `quantize_llama_params`; with LoRA, each projection but lm_head
    becomes {base: quantized, lora_a, lora_b} with random adapters."""
    q = jquant.quantize_llama_params(params, mode)
    if lora_rank:
        for layer in q["params"]["model"].values():
            for part in ("self_attn", "mlp"):
                for name, leaf in list(layer.get(part, {}).items()):
                    n_out = (leaf["scale"] if mode == "int8"
                             else leaf["absmax"]).shape[-1]
                    n_in = (leaf["kernel_q"].shape[0] if mode == "int8"
                            else 2 * leaf["kernel_p"].shape[0])
                    layer[part][name] = {
                        "base": leaf,
                        "lora_a": rng.standard_normal(
                            (n_in, lora_rank)).astype(np.float32) * 0.1,
                        "lora_b": rng.standard_normal(
                            (lora_rank, n_out)).astype(np.float32) * 0.1}
    return q


def _port(cfg, mode, tree) -> LlamaForCausalLM:
    flat = {}
    llama_from_jax(flat, tree, "model")
    m = LlamaForCausalLM(cfg, quantize=mode).eval()
    m.load_state_dict({k: torch.from_numpy(v) for k, v in flat.items()},
                      strict=True)
    return m


@pytest.mark.parametrize("lora", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_quantized_llama_matches_jax(mode, lora):
    cfg = LORA if lora else LLAMA
    rng = np.random.default_rng(4)
    tree = _jax_quantized(_jax_llama_params(cfg, 5), mode, cfg.lora_rank, rng)
    ids = rng.integers(0, cfg.total_vocab, (2, 9))
    ref = jllama.LlamaForCausalLM(jax_sub_config(cfg), quantized=mode).apply(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(ids))
    port = _port(cfg, mode, tree)
    assert port.quantized == mode
    with torch.no_grad():
        out = port(torch.from_numpy(ids))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("mode", MODES)
def test_quantize_in_place_equals_jax_tree(mode):
    """quantize_llama_ of a built float model (a LoRA one: the bases are
    quantized, the adapters kept) holds the JAX tree's codes bit for bit;
    no float projection weight is left."""
    flat = rerandomize_(LlamaForCausalLM(LORA), seed=6)
    model = LlamaForCausalLM(LORA)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in flat.items()})
    adapter = model.model.layers[1].mlp.up_proj.lora_b
    tquant.quantize_llama_(model, mode)
    assert model.model.layers[1].mlp.up_proj.lora_b is adapter
    plain = {k: v for k, v in flat.items() if not tlora.is_adapter(k)}
    ref = {}
    llama_from_jax(ref, jquant.quantize_llama_params(
        jconvert.convert_llama(plain, LORA.num_layers), mode),
        "model")
    got = {k: v.numpy() for k, v in model.state_dict().items()
           if not tlora.is_adapter(k)}
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    # the state-dict form gives the same
    sd = tquant.quantize_llama_params(
        {k: torch.from_numpy(v) for k, v in plain.items()}, mode)
    assert {k: v.numpy().tobytes() for k, v in sd.items()} == \
        {k: v.tobytes() for k, v in ref.items()}
    with pytest.raises(ValueError, match="already quantized"):
        tquant.quantize_llama_(model, mode)


@pytest.mark.parametrize("lora", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_quantize_frees_each_float_weight(monkeypatch, mode, lora):
    """quantize_llama_ frees each float projection weight before it
    quantizes the next: when a weight reaches the quantizer, every weight
    quantized before it is dead, so the float and the quantized LLaMA
    never live whole side by side."""
    cfg = LORA if lora else LLAMA
    model = LlamaForCausalLM(cfg)
    name = "quantize_kernel" if mode == "int8" else "quantize_kernel_nf4"
    real, seen = getattr(tquant, name), []

    def spy(w, *args):
        assert all(r() is None for r in seen), \
            f"a float weight outlived its quantization ({len(seen)} done)"
        seen.append(weakref.ref(w))
        return real(w, *args)

    monkeypatch.setattr(tquant, name, spy)
    tquant.quantize_llama_(model, mode)
    assert len(seen) == 7 * cfg.num_layers + 1
    assert all(r() is None for r in seen)


def test_scales_stay_fp32_and_quant_flags():
    m = LlamaForCausalLM(LLAMA, quantize=True)
    assert m.quantized == "int8"
    m.to(torch.bfloat16)
    assert m.lm_head.scale.dtype == torch.float32
    assert m.lm_head.weight_q.dtype == torch.int8
    assert m.model.norm.weight.dtype == torch.bfloat16
    n = LlamaForCausalLM(LLAMA, quantize="nf4").to(torch.bfloat16)
    assert n.model.layers[0].self_attn.q_proj.absmax.dtype == torch.float32
    with pytest.raises(ValueError, match="quantize_llm"):
        LlamaForCausalLM(LLAMA, quantize="int4")
    # int8 holds a quarter of fp32's projection bytes, NF4 about an eighth
    f = tquant.tree_nbytes(LlamaForCausalLM(LLAMA))
    assert tquant.tree_nbytes(LlamaForCausalLM(LLAMA, quantize="int8")) < f / 2
    assert tquant.tree_nbytes(n) < tquant.tree_nbytes(m)


def test_merge_refuses_a_quantized_base():
    m = LlamaForCausalLM(LORA, quantize="nf4")
    with pytest.raises(ValueError, match="merge LoRA before"):
        tlora.merge_lora_params(m.state_dict(), 16.0, 4)


# -- tensor parallelism -------------------------------------------------------------


def quant_tp_group(rank, world, states, llama_cfg, embeds):
    """Rank body: each quantized LLaMA of `states` ({mode: state dict})
    under 2-way tensor parallelism, its trunk on `embeds`, and the shapes
    this rank holds."""
    from open_pandora_tpu_torch.core.config import MeshConfig
    from open_pandora_tpu_torch.parallel.mesh import build_mesh
    from open_pandora_tpu_torch.parallel.tp import shard_llama_

    ms = build_mesh(MeshConfig(model_parallel=world))
    out = {}
    for mode, flat in states.items():
        m = LlamaForCausalLM(llama_cfg, quantize=mode).eval()
        m.load_state_dict({k: torch.from_numpy(v) for k, v in flat.items()})
        shard_llama_(ms, m)
        attn = m.model.layers[0].self_attn
        out[mode, "shapes"] = {
            k: tuple(v.shape) for k, v in
            [*attn.q_proj.named_buffers(), *attn.o_proj.named_buffers()]}
        with torch.no_grad():
            out[mode] = m.trunk(torch.from_numpy(embeds)).numpy()
    return out


@pytest.fixture(scope="module")
def tp_group():
    rng = np.random.default_rng(7)
    params = _jax_llama_params(LLAMA, 8)
    trees = {mode: _jax_quantized(params, mode, 0, rng) for mode in MODES}
    states = {}
    for mode, tree in trees.items():
        states[mode] = {}
        llama_from_jax(states[mode], tree, "model")
    embeds = rng.standard_normal((1, 12, LLAMA.hidden_size)).astype(
        np.float32)
    group = {}

    def run():
        try:
            group["ranks"] = W.run_group(quant_tp_group, 2, states, LLAMA,
                                         embeds)
        except BaseException as e:   # re-raised in the test process
            group["error"] = e
    thread = threading.Thread(target=run)
    thread.start()
    ref = {}
    for mode in MODES:
        with torch.no_grad():
            ref[mode] = _port(LLAMA, mode, trees[mode]).trunk(
                torch.from_numpy(embeds)).numpy()
    thread.join(W.GROUP_TIMEOUT_S + 30)
    assert not thread.is_alive(), "the process group did not finish"
    if "error" in group:
        raise group["error"]
    return group["ranks"], ref


@pytest.mark.parametrize("mode", MODES)
def test_tp_quantized_prefill_matches_one_device(tp_group, mode):
    """2 ranks: int8 column weights and scales split, row weights split
    with scales whole; NF4 kept whole on each rank. The trunk within
    2e-4 of one device."""
    ranks, ref = tp_group
    for r in ranks:
        np.testing.assert_allclose(r[mode], ref[mode], atol=TOL, rtol=TOL)
        shapes = r[mode, "shapes"]
        if mode == "int8":
            assert shapes == {"weight_q": (32, 64), "scale": (32,),
                              "base.weight_q": (64, 32), "base.scale": (64,)}
        else:
            assert shapes == {"base.weight_p": (64, 32),
                              "base.absmax": (64, 1),
                              "base.base.weight_p": (64, 32),
                              "base.base.absmax": (64, 1)}
