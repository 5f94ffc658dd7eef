"""Training entry point of the port: the `dynamicrafter` (UNet only, no
LLM in the loop), `alignment` (connector only, KL to the OpenCLIP text
embedding), `finetune` (UNet + connector, the LLM conditioning in the loop)
and `llm_sft` (ChatUniVi's LLM SFT, full or LoRA) stages, on one device.

Counterpart of open_pandora_tpu/train/trainer.py (reference
trainer.py:24-105, utils/utils_train.py): config merge, workspace, model
and params in the config's dtype policy, the stage's step, metrics
(metrics.jsonl and the `--logger` backends), a sample grid every
`--sample-every` steps, checkpoints of the trainable parameters every
ckpt_every steps and at the end, auto-resume.

Usage:
  python -m open_pandora_tpu_torch.train.trainer \\
      [--synthetic-data | --meta-path meta.csv --data-dir DIR] \\
      --set train.stage=STAGE --max-steps N [--name run1]
      [--logdir ./runs] [--config cfg.yaml]... [--set key.path=value]...
      [--ckpt model.ckpt] [--tiny] [--auto-resume] [--device cpu]
      [--sample-every N] [--logger tensorboard,csv]
      [--chat-path chat.json]... [--image-root DIR] [--video-root DIR]

It runs on the CUDA card unless `--device cpu` is given. `--tiny` takes the
port's small config (pipeline/chat_wm.debug_world_config, 32x32 frames).
Clips come from WebVid (`--meta-path`, clips under `--data-dir`; OpenCV
decodes them, so not on the card's machine), with the config's
frame_stride, fixed_fps and seed, or are synthetic (`--synthetic-data`, or
no `--meta-path`). The alignment, finetune and llm_sft stages build a
WorldModel with random weights (or `--ckpt`, the released composite) and
tokenize with the LLaMA tokenizer (the hash fallback without one).
`llm_sft` reads conversation records from `--chat-path` (images under
`--image-root`, videos under `--video-root`), or without one
`synthetic_conversations(8 * batch)`; with `llama.lora_rank > 0` only the
adapters and mm_projector train. In the finetune and dynamicrafter stages
`--sample-every N` samples a clip every N steps (DDIM-10 from the batch's
first conditioning image and frames, the empty prompt, eval mode) into
loginfo/sample_step<n>.png.

Across cards, one process per card:
  torchrun --nproc-per-node N -m open_pandora_tpu_torch.train.trainer ...
Each process opens the group (parallel.launch.init_distributed: NCCL on
cuda:LOCAL_RANK, gloo with `--device cpu`) and the config's `mesh`
(parallel.mesh.build_mesh: data_parallel -1 takes every rank). The global
batch is batch_size_per_device times the data axis; each rank reads its
slice of it, the step averages the gradients over the data axis with the
optimizer state sharded (ZeRO-2, `mesh.shard_opt_state`). Rank 0 alone
writes the workspace, metrics, sample grids and checkpoints; every rank
resumes from the same checkpoint.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys
import time

import torch

log = logging.getLogger("open_pandora_tpu_torch.train")

STAGES = ("dynamicrafter", "alignment", "finetune", "llm_sft")
# the stages with the LLM in the loop: they build a WorldModel
LLM_STAGES = STAGES[1:]

# settings the config accepts, as the JAX package's does, that no ported
# code reads, with the reason; run() refuses a value other than the default
UNREAD = {
    ("train", "cond_frames"): "the JAX package's trainer does not read it "
                              "either",
}


def build_parser():
    p = argparse.ArgumentParser("open-pandora-torch-trainer")
    p.add_argument("--name", default=time.strftime("run_%Y%m%dT%H%M%S"))
    p.add_argument("--logdir", default="./runs")
    p.add_argument("--config", action="append", default=[],
                   help="YAML config file(s), merged in order (PyYAML)")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   help="dotted config overrides, e.g. train.log_every=1")
    p.add_argument("--ckpt", default=None,
                   help="initial weights: a reference DynamiCrafter "
                        "checkpoint (random weights without it)")
    p.add_argument("--auto-resume", action="store_true")
    p.add_argument("--synthetic-data", action="store_true")
    p.add_argument("--meta-path", default=None,
                   help="WebVid metadata CSV (videoid, page_dir, name)")
    p.add_argument("--data-dir", default=None,
                   help="WebVid root: clips under videos/<page_dir>/")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--sample-every", type=int, default=0,
                   help="every N steps, sample a clip into a PNG grid "
                        "(finetune and dynamicrafter stages)")
    p.add_argument("--tiny", action="store_true",
                   help="the small debug config (smoke mode)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--logger", default="tensorboard",
                   help="comma list of metric backends besides "
                        "metrics.jsonl: tensorboard, csv, wandb, none")
    p.add_argument("--chat-path", action="append", default=[],
                   help="conversation JSON file(s) for train.stage=llm_sft "
                        "(ChatUniVi LazySupervisedDataset records)")
    p.add_argument("--image-root", default=None)
    p.add_argument("--video-root", default=None)
    return p


def run(argv=None):
    """Train as the command line says; returns the final TrainState."""
    from open_pandora_tpu_torch.core.checkpoint import (
        find_latest_checkpoint, init_workspace, restore_params, save_params)
    from open_pandora_tpu_torch.core.config import load_config, param_dtype
    from open_pandora_tpu_torch.eval.inference import (build_model,
                                                       load_checkpoint)
    from open_pandora_tpu_torch.parallel.launch import (init_distributed,
                                                        is_writer,
                                                        local_device)
    from open_pandora_tpu_torch.parallel.mesh import build_mesh
    from open_pandora_tpu_torch.pipeline.chat_wm import (build_world_model,
                                                         debug_world_config)
    from open_pandora_tpu_torch.utils.loggers import MetricsLogger

    args = build_parser().parse_args(argv)
    device = local_device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to train on "
                           "the CPU")
    init_distributed(device)
    if args.tiny:
        cfg = load_config(args.config, args.overrides,
                          base=debug_world_config())
        height = width = 32
        video_len = cfg.unet.temporal_length
    else:
        cfg = load_config(args.config, args.overrides)
        height, width = cfg.train.height, cfg.train.width
        video_len = cfg.train.video_length
    tcfg = cfg.train
    if args.max_steps is not None:
        tcfg = dataclasses.replace(tcfg, max_steps=args.max_steps)
    stage = tcfg.stage
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r}; choose one of {STAGES}")
    for (section, name), waits in UNREAD.items():
        node = getattr(cfg, section)
        if getattr(node, name) != getattr(type(node)(), name):
            raise NotImplementedError(
                f"{section}.{name}={getattr(node, name)!r}: the port does "
                f"not read this setting ({waits}); leave it at its default")

    ms = build_mesh(cfg.mesh)
    writer = is_writer()
    ws = init_workspace(args.logdir, args.name, cfg, write=writer)
    # the UNet's dropout masks: one stream per data rank
    torch.manual_seed(tcfg.seed + ms.data_rank)
    dtype = param_dtype(cfg.dtype_policy)
    gen = torch.Generator(device=device).manual_seed(tcfg.seed)
    if stage in LLM_STAGES:
        model = build_world_model(cfg, device=device, dtype=dtype,
                                  generator=gen)
    else:
        model = build_model(cfg, device=device, dtype=dtype, generator=gen)
    if args.ckpt:
        load_checkpoint(model, args.ckpt)
    state, step_fn = _stage_step(model, tcfg, stage, ms)
    log.info("stage=%s device=%s dtype=%s mesh=%dx%d trainable=%d", stage,
             device, dtype, ms.n_data, ms.n_model,
             sum(p.numel() for p in state.trainable.values()))

    if args.auto_resume:
        latest = find_latest_checkpoint(ws["checkpoints"])
        if latest:
            log.info("resuming from %s", latest)
            restore_params(latest, state.trainable)
            state.step = int(os.path.basename(latest)[5:])
    state = step_fn.shard_state(state)

    loader = _loader(args, cfg, tcfg, stage, (height, width), video_len, ms)
    metrics = (MetricsLogger(ws["loginfo"], backends=args.logger)
               if writer else None)
    gen = torch.Generator(device=device).manual_seed(tcfg.seed)
    t_last, step_last = time.perf_counter(), state.step
    epoch = 0
    try:
        while state.step < tcfg.max_steps:
            for batch in loader.epoch(epoch):
                m = step_fn(state, batch, generator=gen)
                if state.step % tcfg.log_every == 0 or state.step == 1:
                    m = {k: float(v) for k, v in m.items()}   # synchronises
                    now = time.perf_counter()
                    rec = {"sec_per_step": (now - t_last)
                           / (state.step - step_last), **m}
                    t_last, step_last = now, state.step
                    log.info("%s", {"step": state.step, **rec})
                    if writer:
                        metrics.log(state.step, rec)
                if (writer and args.sample_every
                        and state.step % args.sample_every == 0
                        and stage in ("finetune", "dynamicrafter")):
                    path = sample_grid(
                        state.model, batch, cfg, os.path.join(
                            ws["loginfo"], f"sample_step{state.step}.png"))
                    log.info("sample grid -> %s", path)
                if state.step % tcfg.ckpt_every == 0 and writer:
                    save_params(ws["checkpoints"], state.trainable,
                                state.step)
                    log.info("checkpoint @ step %d", state.step)
                if state.step >= tcfg.max_steps:
                    break
            epoch += 1
        if writer:
            save_params(ws["checkpoints"], state.trainable, state.step)
    finally:
        if writer:
            metrics.close()
    log.info("done at step %d", state.step)
    return state


def _stage_step(model, tcfg, stage: str, ms):
    """(TrainState, step function) of a stage (JAX trainer.py:174-190),
    over the mesh `ms`; the state is not yet through step.shard_state."""
    from open_pandora_tpu_torch.train.llm_step import (make_llm_sft_step,
                                                       sft_stage)
    from open_pandora_tpu_torch.train.step import (TrainState,
                                                   make_alignment_step,
                                                   make_finetune_step,
                                                   make_wm_finetune_step)
    if stage == "alignment":
        step_fn, key = make_alignment_step(model, tcfg, ms), stage
    elif stage == "finetune":
        step_fn, key = make_wm_finetune_step(model, tcfg, ms), stage
    elif stage == "llm_sft":
        step_fn, key = make_llm_sft_step(model, tcfg, ms), sft_stage(model)
    else:
        step_fn, key = make_finetune_step(model, tcfg, mesh_spec=ms), stage
    return TrainState.create(model, key, tcfg), step_fn


@torch.no_grad()
def sample_grid(model, batch, cfg, path: str) -> str:
    """A DDIM-10 clip from the batch's first conditioning image and frames
    with the empty prompt (generator seeded 0), in eval mode (the fused
    route on the card), decoded and saved as a PNG grid (JAX
    trainer.py:266-285); every module's mode is restored after (the
    stages train some submodules and keep the rest in eval mode)."""
    from open_pandora_tpu_torch.models.encoders import empty_prompt_tokens
    from open_pandora_tpu_torch.models.world_model import WorldModel
    from open_pandora_tpu_torch.utils.image_grid import save_sample_grid

    dc = model.diffusion if isinstance(model, WorldModel) else model
    modes = [(m, m.training) for m in model.modules()]
    model.eval()
    try:
        text_ctx = dc.encode_text(empty_prompt_tokens(
            1, cfg.clip_text.context_length, device=dc.device))
        z = dc.image_guided_synthesis(
            text_context=text_ctx,
            cond_images=torch.as_tensor(batch["cond_images"][:1]),
            cond_frames=torch.as_tensor(batch["cond_frames"][:1]),
            ddim_steps=10, guidance_scale=cfg.sampler.guidance_scale,
            generator=torch.Generator(device=dc.device).manual_seed(0))
        video = dc.decode(z).float().cpu().numpy()
    finally:
        for m, training in modes:
            m.training = training
    return save_sample_grid(path, video)


def _loader(args, cfg, tcfg, stage: str, hw, video_len: int, ms):
    """The stage's batches (JAX trainer.py:198-239): collated conversations
    for llm_sft; otherwise WebVid clips from `--meta-path`, or synthetic
    ones (with LLaMA caption ids in the LLM stages). Each is this data
    rank's slice of a global batch of batch_size_per_device * n_data (the
    remainder dropped when n_data > 1)."""
    from open_pandora_tpu_torch.data.webvid import (PrefetchLoader,
                                                    SyntheticVideoDataset,
                                                    WebVidDataset)
    from open_pandora_tpu_torch.pipeline.tokenizers import load_tokenizer

    batch = tcfg.batch_size_per_device * ms.n_data
    shard = (ms.data_rank, ms.n_data)
    if stage == "llm_sft":
        from open_pandora_tpu_torch.data.sft import (ConversationDataset,
                                                     synthetic_conversations)
        ds = ConversationDataset(
            args.chat_path, load_tokenizer(), image_root=args.image_root,
            video_root=args.video_root,
            clip_size=cfg.clip_tower.image_size, seed=tcfg.seed,
            records=(None if args.chat_path
                     else synthetic_conversations(8 * batch, tcfg.seed)))

        class SFTLoader:
            def epoch(self, _epoch):
                return ds.batches(batch, cfg, bucket=32,
                                  drop_remainder=ms.n_data > 1, shard=shard)
        return SFTLoader()
    llm = stage in LLM_STAGES
    if args.synthetic_data or not args.meta_path:
        # in the LLM stages cond_images is also the CLIP tower's input
        clip_size = (cfg.clip_tower if llm else cfg.clip_vision).image_size
        ds = SyntheticVideoDataset(video_length=video_len, resolution=hw,
                                   clip_size=clip_size)
    else:
        ds = WebVidDataset(args.meta_path, args.data_dir,
                           video_length=video_len, resolution=hw,
                           frame_stride=tcfg.frame_stride,
                           fixed_fps=tcfg.fixed_fps, seed=tcfg.seed)
    return PrefetchLoader(
        ds, batch, text_len=cfg.clip_text.context_length,
        llm_tokenizer=load_tokenizer() if llm else None, shard=shard)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
