"""Process groups for tests/test_torch_parallel_*.py: `run_group` spawns N
CPU processes (spawn start method, one thread each) that open a gloo group
through the port's parallel.launch.init_distributed, as torchrun's
environment names it, and run one function; each rank's return value comes
back through a file. The functions the ranks run are here too: they import
torch and the port only (no JAX), and build their models from NumPy
arrays the test passes them."""

from __future__ import annotations

import hashlib
import os
import pickle
import socket
import tempfile
import time

import numpy as np
import torch
import torch.multiprocessing as mp

# the longest a group may take before it is killed
GROUP_TIMEOUT_S = 240


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_group(fn, world: int, *args, timeout: float = GROUP_TIMEOUT_S):
    """[fn(rank, world, *args) for each rank], run in `world` spawned
    processes of one gloo group."""
    out_dir = tempfile.mkdtemp(prefix="torch_parallel_")
    ctx = mp.start_processes(_entry, args=(world, free_port(), fn, args,
                                           out_dir),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__}: group of {world} ran "
                                   f"past {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    results = []
    for r in range(world):
        with open(os.path.join(out_dir, f"{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def _entry(rank, world, port, fn, args, out_dir):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port), OMP_NUM_THREADS="1")
    torch.set_num_threads(1)
    import torch.distributed as dist

    from open_pandora_tpu_torch.parallel.launch import init_distributed
    assert init_distributed("cpu")
    try:
        res = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def digest(tensors: dict) -> str:
    """One hash of a {name: tensor} dict's bytes, to compare ranks."""
    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(np.ascontiguousarray(tensors[k]).tobytes())
    return h.hexdigest()


def n_sharded(model) -> int:
    """How many of the model's parameters are FSDP DTensors."""
    from torch.distributed.tensor import DTensor
    return sum(isinstance(p, DTensor) for p in model.parameters())


def full(p) -> np.ndarray:
    """A parameter's whole value (an FSDP DTensor gathered) as NumPy."""
    from torch.distributed.tensor import DTensor
    if isinstance(p, DTensor):
        p = p.full_tensor()
    return p.detach().numpy().copy()


# -- the training cases ------------------------------------------------------

UNET = "model.diffusion_model"


def dc_model(flat, cfg):
    """The tiny DynamiCrafter on `flat`'s weights, fp32, dropout off."""
    from open_pandora_tpu_torch.eval.inference import build_model
    port = build_model(cfg, device="cpu")
    port.load_state_dict({k: torch.from_numpy(v) for k, v in flat.items()})
    for m in port.modules():    # the temporal conv blocks' 0.1 as well
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return port


def every_leaf(fn):
    """Run fn() with FSDP taking every leaf it can split (min_size 1), so
    that each module's way of reading its weights meets a sharded one."""
    import functools
    from unittest import mock

    from open_pandora_tpu_torch.parallel.mesh import apply_fsdp
    with mock.patch("open_pandora_tpu_torch.train.step.apply_fsdp",
                    functools.partial(apply_fsdp, min_size=1)):
        return fn()


def dc_step(flat, cfg, batch, draws, tcfg, ms=None, fsdp=False):
    """One `dynamicrafter` step; with `ms`, on this rank's slice of
    `batch` (the global batch). Returns its metrics, the slot kinds of the
    optimizer, the UNet's parameters after it and its clipped gradients
    (one device only)."""
    from open_pandora_tpu_torch.parallel.mesh import shard_batch
    from open_pandora_tpu_torch.train.step import (TrainState,
                                                   make_finetune_step)
    model = dc_model(flat, cfg)
    step = make_finetune_step(model, tcfg, mesh_spec=ms, fsdp=fsdp)
    state = TrainState.create(model, "dynamicrafter", tcfg)
    if ms is not None:
        state = step.shard_state(state)
        batch = shard_batch(ms, batch)
    m = step(state, batch,
             draws={k: torch.from_numpy(v) for k, v in draws.items()})
    kinds = [s.kind for s in state.optimizer.slots]
    out = {"metrics": {k: float(v) for k, v in m.items()},
           "kinds": {k: kinds.count(k) for k in ("rep", "shard", "fsdp")},
           "n_sharded": n_sharded(state.model),
           "params": {k: full(p) for k, p in state.trainable.items()}}
    if ms is None:
        out["grads"] = {k: p.grad.numpy().copy()
                        for k, p in state.trainable.items()}
    return out


def opt_tree(seed: int):
    """Leaves that ZeRO-2 takes each way at 2 ranks: sharded on axis 0, on
    axis 1, indivisible (replicated, and 8-bit padded blocks), small."""
    rng = np.random.default_rng(seed)
    shapes = {"w0": (300, 256), "w1": (257, 512), "odd": (257, 259),
              "b": (64,)}
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


def opt_steps(tcfg, ms=None, steps: int = 3):
    """`steps` updates of the port's Optimizer over opt_tree(0) with the
    gradients opt_tree(1 + i), the same on every rank; the parameters and
    each slot's 8-bit state (dequantized, per rank) after."""
    from open_pandora_tpu_torch.train.optim import Optimizer
    from open_pandora_tpu_torch.train.optim8bit import AdamW8bit, dequantize
    params = {k: torch.nn.Parameter(torch.from_numpy(v))
              for k, v in opt_tree(0).items()}
    opt = Optimizer(params, tcfg, ms)
    norms = []
    for i in range(steps):
        for k, g in opt_tree(1 + i).items():
            params[k].grad = torch.from_numpy(g)
        norms.append(float(opt.step()))
    out = {"params": {k: p.detach().numpy().copy()
                      for k, p in params.items()},
           "norms": norms, "kinds": [s.kind for s in opt.slots]}
    if isinstance(opt.adamw, AdamW8bit):
        a = opt.adamw
        out["mu"] = [dequantize(q, (q.q.numel(),), a.block).numpy()
                     for q in a.mu]
        out["nu"] = [dequantize(q, (q.q.numel(),), a.block).numpy()
                     for q in a.nu]
    return out


def sft_world(cfg, seed: int):
    from open_pandora_tpu_torch.pipeline.chat_wm import build_world_model
    return build_world_model(
        cfg, device="cpu",
        generator=torch.Generator().manual_seed(seed))


def sft_batch(cfg, shard=(0, 1)):
    """This rank's slice of the first global SFT batch (2 conversations)
    of the synthetic records."""
    from open_pandora_tpu_torch.data.sft import (ConversationDataset,
                                                 synthetic_conversations)
    from open_pandora_tpu_torch.pipeline.tokenizers import load_tokenizer
    ds = ConversationDataset([], load_tokenizer(),
                             clip_size=cfg.clip_tower.image_size,
                             records=synthetic_conversations(8, 0))
    return next(iter(ds.batches(2, cfg, bucket=32, drop_remainder=True,
                                shard=shard)))


def sft_step(cfg, seed, tcfg, ms=None, fsdp=False):
    """One llm_sft step (LoRA when cfg has adapters) on the first global
    SFT batch (this rank's slice over a mesh)."""
    from open_pandora_tpu_torch.train.llm_step import (make_llm_sft_step,
                                                       sft_stage)
    from open_pandora_tpu_torch.train.step import TrainState
    wm = sft_world(cfg, seed)
    step = make_llm_sft_step(wm, tcfg, mesh_spec=ms, fsdp=fsdp)
    state = TrainState.create(wm, sft_stage(wm), tcfg)
    if ms is not None:
        state = step.shard_state(state)
    batch = sft_batch(cfg, (ms.data_rank, ms.n_data) if ms else (0, 1))
    m = step(state, batch)
    kinds = [s.kind for s in state.optimizer.slots]
    out = {"metrics": {k: float(v) for k, v in m.items()},
           "kinds": {k: kinds.count(k) for k in ("rep", "shard", "fsdp")},
           "n_sharded": n_sharded(state.model),
           "params": {k: full(p) for k, p in state.trainable.items()}}
    if ms is None:
        out["grads"] = {k: p.grad.numpy().copy()
                        for k, p in state.trainable.items()}
    return out


def trainer_run(logdir: str, name: str, stage_args, rank: int):
    """trainer.run for 2 steps on the tiny config; on ranks other than 0
    every file opened for writing and every directory made under `logdir`
    is recorded. Returns (final step, those paths)."""
    import builtins
    from unittest import mock

    from open_pandora_tpu_torch.train import trainer
    written = []
    real_open, real_makedirs = builtins.open, os.makedirs

    def spy_open(path, mode="r", *a, **kw):
        if any(c in mode for c in "wax+") and str(path).startswith(logdir):
            written.append(str(path))
        return real_open(path, mode, *a, **kw)

    def spy_makedirs(path, *a, **kw):
        if str(path).startswith(logdir):
            written.append(str(path))
        return real_makedirs(path, *a, **kw)

    patches = ([] if rank == 0 else
               [mock.patch("builtins.open", spy_open),
                mock.patch("os.makedirs", spy_makedirs)])
    for p in patches:
        p.start()
    try:
        state = trainer.run(["--tiny", "--synthetic-data", "--device", "cpu",
                             "--max-steps", "2", "--logdir", logdir,
                             "--name", name, "--logger", "csv",
                             "--set", "train.log_every=1", *stage_args])
    finally:
        for p in patches:
            p.stop()
    return state.step, written


def train_group(rank, world, flat, cfg, batch, draws, train_kw, sft_cfg,
                logdir):
    """Every case of tests/test_torch_parallel_train.py, on one group."""
    from open_pandora_tpu_torch.core.config import MeshConfig, TrainConfig
    from open_pandora_tpu_torch.parallel.mesh import build_mesh

    ms = build_mesh(MeshConfig())
    out = {}
    for name, kw, fsdp in (("zero2", {}, False),
                           ("zero2_8bit", {"optimizer": "adamw8bit"}, False),
                           ("fsdp", {}, True), ("fsdp_all", {}, True)):
        def run():
            return dc_step(flat, cfg, batch, draws,
                           TrainConfig(**train_kw, **kw), ms, fsdp)
        r = every_leaf(run) if name == "fsdp_all" else run()
        r["digest"] = digest(r["params"])
        if rank:
            del r["params"]
        out[name] = r
    for name, clip in (("opt", 1e9), ("opt_clip", 0.5)):
        for opt in ("adamw", "adamw8bit"):
            out[name, opt] = opt_steps(TrainConfig(
                optimizer=opt, learning_rate=1e-2, weight_decay=0.01,
                grad_clip_norm=clip), ms)
    ms12 = build_mesh(MeshConfig(model_parallel=2))   # one data rank
    for opt in ("adamw", "adamw8bit"):
        out["opt_dp1", opt] = opt_steps(TrainConfig(
            optimizer=opt, learning_rate=1e-2, weight_decay=0.01,
            grad_clip_norm=1e9), ms12)
    sft_kw = dict(learning_rate=1e-3, grad_clip_norm=1.0)
    for name, fsdp in (("sft", False), ("sft_fsdp", True)):
        out[name] = sft_step(sft_cfg, 5, TrainConfig(**sft_kw), ms, fsdp)
    out["sft_fsdp_all"] = every_leaf(lambda: sft_step(
        sft_cfg, 5, TrainConfig(**sft_kw), ms, True))
    out["trainer"] = trainer_run(logdir, "dc", ["--set",
                                                "train.stage=dynamicrafter"],
                                 rank)
    out["trainer_sft"] = trainer_run(
        logdir, "sft", ["--set", "train.stage=llm_sft",
                        "--set", "llama.lora_rank=4"], rank)
    return out


# -- the inference cases -----------------------------------------------------

def synth_kwargs(cfg, seed: int):
    """image_guided_synthesis arguments (DDIM-3, CFG 7.5), the generator
    seeded."""
    rng = np.random.default_rng(seed)
    hw = 32
    text = rng.standard_normal((1, cfg.unet.text_context_len,
                                cfg.unet.context_dim)).astype(np.float32)
    img = rng.random((1, hw, hw, 3), np.float32)
    return dict(text_context=torch.from_numpy(text * 0.2),
                cond_images=torch.from_numpy(img),
                cond_frames=torch.from_numpy(img[:, None] * 2 - 1),
                ddim_steps=3, guidance_scale=7.5, fs=3,
                generator=torch.Generator().manual_seed(seed))


def infer_group(rank, world, flat, cfg, z, llama_flat, llama_cfg, ids,
                qkv, embeds):
    """Every case of tests/test_torch_parallel_infer.py, on one group of
    4: a (2, 2) mesh and a (4, 1) mesh over it."""
    from open_pandora_tpu_torch.core.config import MeshConfig
    from open_pandora_tpu_torch.models.llama import LlamaForCausalLM
    from open_pandora_tpu_torch.parallel.mesh import build_mesh, shard_rows
    from open_pandora_tpu_torch.parallel.sharded_infer import (
        sharded_decode, sharded_synthesis)
    from open_pandora_tpu_torch.parallel.sp import (ring_attention,
                                                    sp_llama_prefill)
    from open_pandora_tpu_torch.parallel.tp import shard_llama_

    ms22 = build_mesh(MeshConfig(model_parallel=2))
    ms41 = build_mesh(MeshConfig())
    out = {}
    dc = dc_model(flat, cfg).eval()
    with torch.no_grad():
        out["synth"] = sharded_synthesis(dc, ms22,
                                         **synth_kwargs(cfg, 5)).numpy()
        out["synth_ref"] = dc.image_guided_synthesis(
            **synth_kwargs(cfg, 5)).numpy()
        try:   # 2 CFG streams over 4 data ranks
            sharded_synthesis(dc, ms41, **synth_kwargs(cfg, 5))
        except ValueError as e:
            out["synth_error"] = str(e)
        zt = torch.from_numpy(z)
        out["decode"] = sharded_decode(dc, ms41, zt).numpy()
        out["decode_ref"] = dc.decode(zt).numpy()
        try:   # 6 frames over 4 data ranks
            sharded_decode(dc, ms41, zt[:, :3].repeat(1, 2, 1, 1, 1))
        except ValueError as e:
            out["decode_error"] = str(e)

        def llama():
            m = LlamaForCausalLM(llama_cfg).eval()
            m.load_state_dict({k: torch.from_numpy(v)
                               for k, v in llama_flat.items()})
            return m
        tids = torch.from_numpy(ids)
        tp = shard_llama_(ms22, llama())
        out["tp_heads"] = tp.model.layers[0].self_attn.heads
        out["tp_q_shape"] = tuple(tp.model.layers[0].self_attn.q_proj.weight
                                  .shape)
        out["tp"] = tp(tids).numpy()                       # 2-way TP
        out["tp_dp"] = tp(shard_rows(tids, ms22.n_data,    # 2x2
                                     ms22.data_rank)).numpy()
        q, k, v = (torch.from_numpy(a) for a in qkv)
        loc = [shard_rows(t.transpose(0, 1), 4, ms41.data_rank)
               .transpose(0, 1) for t in (q, k, v)]
        for causal in (False, True):
            out["ring", causal] = ring_attention(*loc, ms=ms41,
                                                 causal=causal).numpy()
        out["prefill"] = sp_llama_prefill(llama(), torch.from_numpy(embeds),
                                          ms=ms41).numpy()
        try:
            sp_llama_prefill(llama(), torch.from_numpy(embeds[:, :30]),
                             ms=ms41)
        except ValueError as e:
            out["prefill_error"] = str(e)
    return out
