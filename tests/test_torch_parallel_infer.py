"""The port's inference across processes: one real gloo group of 4 CPU
ranks (tests/torch_parallel_workers.py) over a (2, 2) and a (4, 1) mesh.

Its cases: 2-way sharded_synthesis (CFG streams split) and 4-way
sharded_decode (frames split) against the unsharded calls on the same
rank; the LLaMA with 2-way tensor parallelism, alone and on the 2x2
(data, model) mesh, against the replicated forward and JAX's TP forward
on a 2x2 mesh of the 8-device CPU mesh; 4-way ring attention, causal and
not, against JAX's ring_attention over 4 devices; sp_llama_prefill
against JAX's single-device trunk; and the ValueErrors of an axis that
does not divide."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_pandora_tpu.core import convert as jconvert
from open_pandora_tpu.core.config import MeshConfig as JaxMeshConfig
from open_pandora_tpu.models.llama import LlamaForCausalLM as JaxLlama
from open_pandora_tpu.parallel.mesh import build_mesh as jax_build_mesh
from open_pandora_tpu.parallel.sp import ring_attention as jax_ring
from open_pandora_tpu.parallel.tp import shard_llama_params
from open_pandora_tpu_torch.core import config as tcfg
from open_pandora_tpu_torch.eval.inference import build_model, debug_config
from open_pandora_tpu_torch.models.llama import LlamaForCausalLM
import torch_parallel_workers as W
from torch_parity import jax_sub_config, max_abs, rerandomize_, to_jax

WORLD = 4
# tests/test_torch_llm_stack.py's LLaMA: 4 heads, MLP width 96
LLAMA = tcfg.LLaMAConfig(vocab_size=97, hidden_size=64, intermediate_size=96,
                         num_layers=2, num_heads=4)
# JAX tests/test_sharded_infer.py holds its sharded decode to the unsharded
# call at atol = rtol = 2e-5
SHARD_TOL = 2e-5
# tests/test_torch_slice.py: one fp32 UNet eval differs by summation order
# (here batch 1 against batch 2), CFG 7.5 weighs the streams' difference
# by 7.5 and the steps compound it: 5e-4 of the latents' scale
SYNTH_REL = 5e-4
# tests/test_torch_llm_stack.py: fp32 LLaMA within 1e-4 of the scale
LLAMA_REL = 1e-4
# JAX tests/test_sp.py holds its ring to full attention at 2e-5
RING_TOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The models are tiny: one intra-op thread keeps this process from
    competing for the cores with its process group and the suite's other
    workers (a module fixture, so that it covers `cases`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cases(cpu_devices):
    import threading

    cfg = debug_config()
    flat = rerandomize_(build_model(cfg, device="cpu"), seed=13)
    rng = np.random.default_rng(14)
    z = rng.standard_normal((1, cfg.unet.temporal_length, 16, 16,
                             cfg.vae.z_channels)).astype(np.float32)
    llama_flat = rerandomize_(LlamaForCausalLM(LLAMA), seed=9)
    ids = rng.integers(0, LLAMA.total_vocab, (2, 8))
    qkv = [rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
           for _ in range(3)]
    jmodel = JaxLlama(jax_sub_config(LLAMA))
    jparams = to_jax(jconvert.convert_llama(llama_flat, LLAMA.num_layers))
    seq = jnp.asarray(rng.integers(1, LLAMA.total_vocab, (1, 64)))
    embeds = np.asarray(jmodel.apply(jparams, seq, method=JaxLlama.embed))
    group = {}

    def run():
        try:
            group["ranks"] = W.run_group(W.infer_group, WORLD, flat, cfg, z,
                                         llama_flat, LLAMA, ids, qkv, embeds)
        except BaseException as e:   # re-raised in the test process
            group["error"] = e
    thread = threading.Thread(target=run)
    thread.start()

    ms22 = jax_build_mesh(JaxMeshConfig(data_parallel=2, model_parallel=2),
                          devices=cpu_devices[:4])
    with ms22.mesh:
        jax_tp = np.asarray(jax.jit(jmodel.apply)(
            shard_llama_params(ms22, jparams), jnp.asarray(ids)))
    mesh4 = jax_build_mesh(JaxMeshConfig(data_parallel=4),
                           devices=cpu_devices[:4]).mesh
    jq = [jnp.asarray(a) for a in qkv]
    jax_rings = {c: np.asarray(jax_ring(*jq, mesh=mesh4, axis="data",
                                        causal=c)) for c in (False, True)}
    trunk = np.asarray(jmodel.apply(jparams, jnp.asarray(embeds),
                                    method=JaxLlama.trunk))
    port = LlamaForCausalLM(LLAMA).eval()
    port.load_state_dict({k: torch.from_numpy(v)
                          for k, v in llama_flat.items()})
    with torch.no_grad():
        replicated = port(torch.from_numpy(ids)).numpy()
    thread.join(W.GROUP_TIMEOUT_S + 30)
    assert not thread.is_alive(), "the process group did not finish"
    if "error" in group:
        raise group["error"]
    return {"ranks": group["ranks"], "jax_tp": jax_tp, "jax_ring": jax_rings,
            "trunk": trunk, "replicated": replicated}


def test_sharded_synthesis_matches_unsharded(cases):
    """DDIM-3 with 2-way CFG, the two streams on two data ranks: every rank
    ends with the unsharded latents."""
    for r in cases["ranks"]:
        assert r["synth"].shape == r["synth_ref"].shape == (1, 4, 16, 16, 4)
        scale = float(np.abs(r["synth_ref"]).max())
        assert scale > 0.1
        assert max_abs(r["synth"], r["synth_ref"]) < SYNTH_REL * scale


def test_sharded_decode_matches_unsharded(cases):
    """4 frames on 4 ranks, gathered: the unsharded decode."""
    for r in cases["ranks"]:
        assert r["decode"].shape == r["decode_ref"].shape
        np.testing.assert_allclose(r["decode"], r["decode_ref"],
                                   atol=SHARD_TOL, rtol=SHARD_TOL)


def test_sharded_paths_reject_an_indivisible_axis(cases):
    r = cases["ranks"][0]
    assert "not divisible by data axis 4" in r["synth_error"]
    assert "temporal length 6 % mesh 4 != 0" in r["decode_error"]
    assert "sequence 30 not divisible" in r["prefill_error"]


def test_tp_forward_matches_replicated_and_jax(cases):
    """2-way TP (each rank 2 of the 4 heads, half the MLP columns): the
    logits of every rank against the port's replicated forward and JAX's
    TP forward on its 2x2 mesh."""
    for r in cases["ranks"]:
        assert r["tp_heads"] == 2
        assert r["tp_q_shape"] == (32, 64)
        for want in (cases["replicated"], cases["jax_tp"]):
            assert max_abs(r["tp"], want) <= LLAMA_REL * float(
                np.abs(want).max())


def test_tp_on_data_model_mesh(cases):
    """On the 2x2 (data, model) mesh each data rank runs TP on its row of
    the batch: ranks 0 and 1 hold row 0, ranks 2 and 3 row 1."""
    want = cases["jax_tp"]
    for rank, r in enumerate(cases["ranks"]):
        row = want[rank // 2:rank // 2 + 1]
        assert max_abs(r["tp_dp"], row) <= LLAMA_REL * float(
            np.abs(want).max())


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_jax(cases, causal):
    """Rank r's rows [16 r, 16 r + 16) of the 4-way ring against JAX's
    ring_attention over 4 devices."""
    got = np.concatenate([r["ring", causal] for r in cases["ranks"]], axis=1)
    np.testing.assert_allclose(got, cases["jax_ring"][causal],
                               atol=RING_TOL, rtol=RING_TOL)


def test_sp_llama_prefill_matches_trunk(cases):
    """The LLaMA trunk over 64 rows, every layer's causal attention on the
    4-way ring: every rank's gathered hidden states against JAX's trunk on
    one device."""
    want = cases["trunk"]
    for r in cases["ranks"]:
        assert r["prefill"].shape == want.shape
        assert max_abs(r["prefill"], want) <= LLAMA_REL * float(
            np.abs(want).max())
