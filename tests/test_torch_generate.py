"""PyTorch port, KV-cache decoding (models/llama_generate.py) against the
JAX package (a 2-layer LLaMA, fp32, CPU): the prefill's cache, the first
token's logits, greedy ids for 8 tokens and through eos, sampling under a
generator; and the decode held to a naive re-prefill of prompt + tokens,
float and quantized."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_pandora_tpu.core import convert as jconvert
from open_pandora_tpu.models import llama_generate as jgen
from open_pandora_tpu.models.llama import LlamaForCausalLM as JaxLlama
from open_pandora_tpu_torch.core import config as tcfg
from open_pandora_tpu_torch.models import llama_generate as tgen
from open_pandora_tpu_torch.models.llama import LlamaForCausalLM
from open_pandora_tpu_torch.models.quant import quantize_llama_
from torch_parity import jax_sub_config, max_abs, rerandomize_, to_jax

LLAMA = tcfg.LLaMAConfig(vocab_size=97, hidden_size=64, intermediate_size=96,
                         num_layers=2, num_heads=4)
N_NEW = 8


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its params, the port's model, prompt embeddings (2, 7,
    64)) on the same seeded weights."""
    port = LlamaForCausalLM(LLAMA).eval()
    flat = rerandomize_(port, seed=41)
    # larger logits than the 0.1-scale default: fewer near ties for argmax
    with torch.no_grad():
        port.lm_head.weight.mul_(4.0)
    flat["lm_head.weight"] = port.lm_head.weight.detach().numpy().copy()
    jmodel = JaxLlama(jax_sub_config(LLAMA))
    params = to_jax(jconvert.convert_llama(flat, LLAMA.num_layers))
    ids = np.random.default_rng(42).integers(3, LLAMA.total_vocab, (2, 7))
    embeds = np.array(jmodel.apply(params, jnp.asarray(ids),
                                   method=JaxLlama.embed))
    return jmodel, params, port, embeds


def test_prefill_cache_matches_jax(pair):
    jmodel, params, port, embeds = pair
    ref_last, ref_cache = jgen.prefill_cache(jmodel, params,
                                             jnp.asarray(embeds), 12)
    last, cache = tgen.prefill_cache(port, torch.from_numpy(embeds), 12)
    assert len(cache) == LLAMA.num_layers
    assert max_abs(last, ref_last) <= 1e-5
    for i, (k, v) in enumerate(cache):
        assert k.shape == v.shape == (2, 12, 4, 16)
        assert max_abs(k, ref_cache[f"layers_{i}"]["k"]) <= 1e-5
        assert max_abs(v, ref_cache[f"layers_{i}"]["v"]) <= 1e-5
        assert not k[:, 7:].any() and not v[:, 7:].any()


def test_first_token_logits_match_jax(pair):
    jmodel, params, port, embeds = pair
    ref = jgen.first_token_logits(jmodel, params, jnp.asarray(embeds))
    out = tgen.first_token_logits(port, torch.from_numpy(embeds))
    assert out.shape == ref.shape == (2, LLAMA.total_vocab)
    assert max_abs(out, ref) <= 1e-4


def test_greedy_ids_match_jax(pair):
    jmodel, params, port, embeds = pair
    ref = np.asarray(jgen.greedy_generate(jmodel, params, jnp.asarray(embeds),
                                          max_new_tokens=N_NEW,
                                          eos_token_id=-1))
    out = tgen.greedy_generate(port, torch.from_numpy(embeds),
                               max_new_tokens=N_NEW, eos_token_id=-1)
    assert out.dtype == torch.int64 and out.shape == (2, N_NEW)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert len(set(ref[0].tolist())) > 1            # not one token repeated


def test_greedy_stops_at_eos_as_jax(pair):
    """eos = the third token of row 0: row 0 is eos from there on, row 1
    runs on unless it meets that token too; both as in JAX."""
    jmodel, params, port, embeds = pair
    free = tgen.greedy_generate(port, torch.from_numpy(embeds),
                                max_new_tokens=N_NEW, eos_token_id=-1)
    eos = int(free[0, 2])
    ref = np.asarray(jgen.greedy_generate(jmodel, params, jnp.asarray(embeds),
                                          max_new_tokens=N_NEW,
                                          eos_token_id=eos))
    out = tgen.greedy_generate(port, torch.from_numpy(embeds),
                               max_new_tokens=N_NEW, eos_token_id=eos)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (out[0, 2:] == eos).all()
    np.testing.assert_array_equal(out[0, :2].numpy(), free[0, :2].numpy())


def test_sampling_is_deterministic_under_a_generator(pair):
    _, _, port, embeds = pair
    x = torch.from_numpy(embeds)

    def sample(seed):
        return tgen.greedy_generate(
            port, x, max_new_tokens=N_NEW, eos_token_id=-1, temperature=1.5,
            generator=torch.Generator().manual_seed(seed))
    a, b, c = sample(5), sample(5), sample(6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    greedy = tgen.greedy_generate(port, x, max_new_tokens=N_NEW,
                                  eos_token_id=-1)
    # the first token is argmax either way; no generator means greedy
    assert torch.equal(a[:, 0], greedy[:, 0])
    assert torch.equal(tgen.greedy_generate(
        port, x, max_new_tokens=N_NEW, eos_token_id=-1, temperature=1.5),
        greedy)


@pytest.mark.parametrize("mode", [False, "int8", "nf4"])
def test_decode_matches_naive_reprefill(pair, mode):
    """Each decode step's logits against the trunk re-run over prompt +
    tokens so far (JAX tests/test_generate_eval.py's check), for 8 steps."""
    _, _, port, embeds = pair
    model = LlamaForCausalLM(LLAMA).eval()
    model.load_state_dict(port.state_dict())
    quantize_llama_(model, mode)
    x = torch.from_numpy(embeds)
    L = x.shape[1]
    with torch.no_grad():
        last, cache = tgen.prefill_cache(model, x, L + N_NEW)
        tok = model.lm_head(last).argmax(-1)
        seq = x
        for i in range(N_NEW):
            logits = tgen.decode_step(model, tok, L + i, cache)
            seq = torch.cat([seq, model.embed(tok)[:, None]], dim=1)
            naive = model.lm_head(model.trunk(seq)[:, -1])
            assert max_abs(logits, naive) <= 1e-4
            tok = logits.argmax(-1)
