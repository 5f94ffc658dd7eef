"""Image-to-video clips through the port's entry,
`eval.inference.synthesize`, one client in a closed loop: clip after clip,
each with its own image, prompt and sampler seed, at the configuration's
frame size, steps, guidance and frame stride, in bf16.

Set-up: the model in bf16 on the card with the benchmark's weights, the
kernel library built or loaded, one DDIM-2 clip (one conditioning, two CFG
UNet evals, one decode: every shape of the cell). Window: clips back to
back until `seconds` have passed; it closes when the last started clip
ends. A recorder at `apply_model` and `decode` keeps what the timed path
produced (the latent and the UNet output at the steps the check reads, the
context, the timesteps, the decoded latents); the returned frames are kept
too.

Check, after the window, with the program freed: one clip drawn from the
seed, held to the float32 reference (benchmark/reference), which works out
the conditioning again from the request and follows the program's own
latents at three steps drawn from the seed (the first, the last and one
between): the conditioning (CLIP text, ViT-H and Resampler, the VAE encode
of the frame), the x_T the program started from, the batched CFG UNet eval
at each drawn step, the DDIM update with guidance rescale from the
program's own eval, and the VAE decode of the latents the program decoded.
"""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch

import flops
from reference import model as ref
from reference import sampler as refs
from traffic.generator import np_seed

PEAK_BF16 = 989e12
# the numbers `check` compares, each with the limit the cell's file gives
NUMBERS = ("cond", "start", "timestep", "eval", "step", "decode")
# the warm-up request's index, one no window reaches
WARMUP_INDEX = 2 ** 31


def port_config(config: dict):
    """The program's PandoraConfig from the configuration file."""
    from open_pandora_tpu_torch.core import config as pc

    groups = {"vae": pc.VAEConfig, "unet": pc.UNet3DConfig,
              "clip_text": pc.CLIPTextConfig,
              "clip_vision": pc.CLIPVisionConfig,
              "resampler": pc.ResamplerConfig,
              "diffusion": pc.DiffusionConfig, "sampler": pc.SamplerConfig,
              "train": pc.TrainConfig}
    kw = {}
    for key, cls in groups.items():
        if key in config:
            kw[key] = cls(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in config[key].items()})
    return pc.PandoraConfig(**kw)


class Recorder:
    """Wraps the model's `apply_model` and `decode` (instance attributes) to
    keep, per clip, what the timed path produced at the steps the check
    reads (`keep`: step indices): the latent in and the UNet's output; the
    first eval's context and conditioning latents; every eval's timestep;
    the latents decoded. Copies stay on the device.
    `on_eval(n)` is called after the n-th eval of a clip."""

    def __init__(self, model, keep):
        self.clips, self.cur, self.keep = [], None, set(keep)
        self.on_eval = None
        real_apply, real_decode = model.apply_model, model.decode

        def apply_model(x, t, ctx, zc, fs=None):
            out = real_apply(x, t, ctx, zc, fs)
            c = self.cur
            if c is not None:
                j = c["n"]
                if j == 0:
                    c.update(ctx=ctx, z_cond=zc[:1])
                if j in self.keep or j - 1 in self.keep:
                    c["x"][j] = x[:1].clone()
                if j in self.keep:
                    c["out"][j] = out.clone()
                c["t"].append(t[:1])
                c["n"] = j + 1
                if self.on_eval is not None:
                    self.on_eval(j + 1)
            return out

        def decode(z, frame_chunk=1):
            if self.cur is not None:
                self.cur["z"] = z.clone()
            return real_decode(z, frame_chunk=frame_chunk)

        model.apply_model, model.decode = apply_model, decode

    def start(self, request):
        self.cur = {"request": request, "x": {}, "out": {}, "t": [], "n": 0}

    def finish(self, frames):
        c = self.cur
        c["frames"], c["t"] = frames, torch.cat(c["t"]).tolist()
        self.clips.append(c)
        self.cur = None


def check_steps(seed: int, n: int) -> list:
    """The DDIM steps the check reads: the first, the last and one between,
    drawn from the seed."""
    rng = np.random.default_rng(np_seed(seed, 8))
    return sorted({0, n - 1, int(rng.integers(1, n - 1)) if n > 2 else 0})


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| in float64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp(min=1e-300))


class Program:
    """The program under test, set up for a cell: the model in bf16 with the
    benchmark's weights, the kernel library, the tokenizer, the recorder."""

    def __init__(self, cell):
        from open_pandora_tpu_torch.eval.inference import build_model
        from open_pandora_tpu_torch.ops import kernels
        from open_pandora_tpu_torch.pipeline.tokenizers import (
            load_clip_tokenizer)
        import weights

        self.cell, self.dev = cell, cell.device
        self.model = build_model(port_config(cell.config), device=self.dev,
                                 dtype=torch.bfloat16)
        cell.mark("model")
        weights.fill_(self.model, cell.seed)
        cell.mark("weights")
        if self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.dev)
            kernels.library()
        cell.mark("kernels")
        self.tokenizer = load_clip_tokenizer()
        self.steps = check_steps(cell.seed, cell.config["sampler"]["steps"])
        self.rec = Recorder(self.model, self.steps)

    def clip(self, req, steps, timings=None):
        from open_pandora_tpu_torch.eval.inference import synthesize

        cfg, s = self.cell.config, self.cell.config["sampler"]
        gen = torch.Generator(device=self.dev).manual_seed(req["noise_seed"])
        return synthesize(
            self.model, req["image"], req["prompt"],
            height=cfg["video"]["height"], width=cfg["video"]["width"],
            ddim_steps=steps, guidance_scale=s["guidance_scale"],
            guidance_rescale=s["guidance_rescale"], eta=s["eta"], fs=s["fs"],
            generator=gen, tokenizer=self.tokenizer, timings=timings)


def pick(clips: list, seed: int, steps) -> dict:
    """One finished clip drawn from the seed: what the recorder kept of
    it."""
    rng = np.random.default_rng(np_seed(seed, 7))
    c = clips[int(rng.integers(len(clips)))]
    return {k: c[k] for k in ("ctx", "z_cond", "t", "z", "frames",
                              "request", "x", "out", "n")}


def run(cell) -> dict:
    s = cell.config["sampler"]
    prog = Program(cell)
    dev, traffic, rec = cell.device, cell.traffic, prog.rec
    # warm-up: every shape of the cell, one conditioning, two evals, decode
    prog.clip(traffic.request(WARMUP_INDEX), 2)
    cell.sync()
    cell.mark("warm-up")
    setup_s = time.perf_counter() - cell.t_start
    cell.log(f"setup_s {setup_s:.3f}")

    items, traced = [], None
    w0 = time.perf_counter()
    i = 0
    while True:
        req = traffic.request(i)
        rec.start(req)
        timings, profiled = {}, cell.trace and i == cell.trace_item
        if profiled:
            traced = cell.profiler()
            a, k = cell.workload["trace_steps"]
            if not 0 < a < a + k < s["steps"]:
                raise ValueError(f"trace_steps {a}, {k}: not inside a clip")

            def on_eval(n, prof=traced, a=a, b=a + k):
                if n in (a, b):
                    cell.sync()
                    (prof.start if n == a else prof.stop)()
            rec.on_eval = on_eval
        c0 = time.perf_counter()
        frames = prog.clip(req, s["steps"], timings)
        c1 = time.perf_counter()
        rec.on_eval = None
        rec.finish(frames)
        items.append({"wall_s": c1 - c0, "timings": timings,
                      "profiled": profiled, "steps": s["steps"]})
        i += 1
        done = time.perf_counter() - w0 >= cell.seconds
        if done and not (cell.trace and i <= cell.trace_item):
            break
    w1 = time.perf_counter()
    record = {"setup_s": setup_s, "window_s": w1 - w0, "items": items,
              "kind": "i2v", "setup_parts": cell.marks,
              "metrics": {cell.workload["clip_metric"]:
                          (w1 - w0) / len(items), "setup_s": setup_s},
              "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                    if dev.type == "cuda" else 0)}
    if traced is not None:
        from trace import reduce
        record["trace"] = reduce(traced)
        record["trace"]["steps"] = cell.workload["trace_steps"][1]
        del traced
        record["flops_per_item"] = flops.i2v_clip(cell.config)
        record["peak_flops"] = PEAK_BF16

    # -- the check, with the program freed ------------------------------------
    keep, steps = pick(rec.clips, cell.seed, prog.steps), prog.steps
    del rec, prog
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    record["numbers"] = check(cell, keep, steps)["program"]
    record["check_s"] = time.perf_counter() - t0
    return record


def reference_model(config: dict, seed: int, device, fp8: bool = False):
    import weights

    with torch.device("meta"):
        m = ref.DynamiCrafter(config, ref.Numerics(fp8=fp8))
    m = m.to_empty(device=device)
    params = dict(m.named_parameters())
    shapes = {k: tuple(p.shape) for k, p in params.items()}
    with torch.no_grad():
        for name, v in weights.values(shapes, seed, device):
            params[name].copy_(v.float())
    return m


def ref_tokens(prompt: str, n: int) -> list:
    """The OpenCLIP tokenizer's hash stand-in, as the program runs it with
    no BPE file: [SOT, hashed words, EOT, 0 pad]."""
    import hashlib

    ids = [49406]
    for word in prompt.strip().split():
        if len(ids) >= n - 1:
            break
        h = int(hashlib.md5(word.lower().encode()).hexdigest(), 16)
        ids.append(1000 + h % 48000)
    ids.append(49407)
    return (ids + [0] * n)[:n]


@torch.no_grad()
def conditioning(m, config: dict, req: dict, hw) -> tuple:
    """(cond; uncond) contexts (2, L, 1024) and z_cond (1, T, h, w, 4)."""
    n = config["clip_text"]["context_length"]
    dev = m.device
    ids = torch.tensor([ref_tokens(req["prompt"], n),
                        ref_tokens("", n)], device=dev)
    text = m.encode_text(ids)
    image = req["image"].to(dev).float() / 255.0
    img_ctx = m.encode_image(torch.stack([image, torch.zeros_like(image)]))
    ctx = torch.cat([text, img_ctx], dim=1)
    z_cond = m.encode_frame(ref.diffusion_frame(image, hw)[None])
    return ctx, z_cond


@torch.no_grad()
def check(cell, keep: dict, steps, control: bool = False) -> dict:
    """The numbers compared, each with its limit, of the program against the
    float32 reference; with `control`, also of the control (the reference
    with every product's operands in fp8, its latent carried in fp8) put in
    the program's place on the program's own latents."""
    cfgj, dev = cell.config, cell.device
    s = cfgj["sampler"]
    hw = (cfgj["video"]["height"], cfgj["video"]["width"])
    req, n_steps = keep["request"], keep["n"]
    m = reference_model(cfgj, cell.seed, dev)
    ctl = reference_model(cfgj, cell.seed, dev, fp8=True) if control else None
    sch = refs.ddim_steps(ref.SimpleNamespace(**cfgj["diffusion"]),
                          s["steps"], s["eta"])
    prog, alt = {}, {}
    with ref.fp32_exact():
        ctx, z_cond = conditioning(m, cfgj, req, hw)
        prog["cond"] = max(rel(keep["ctx"], ctx), rel(keep["z_cond"], z_cond))
        if ctl is not None:
            c_ctx, c_zc = conditioning(ctl, cfgj, req, hw)
            alt["cond"] = max(rel(c_ctx, ctx), rel(c_zc, z_cond))
        gen = torch.Generator(device=dev).manual_seed(req["noise_seed"])
        shape = keep["x"][0].shape
        x_t = torch.randn(shape, generator=gen, device=dev,
                          dtype=torch.bfloat16)
        prog["start"] = float((keep["x"][0].float() - x_t.float()).abs().max())
        prog["timestep"] = float(max(abs(keep["t"][j] - int(sch["t"][j]))
                                     for j in range(n_steps)))
        noise = [torch.randn(shape, generator=gen, device=dev,
                             dtype=torch.bfloat16) for _ in range(n_steps)]
        fs = torch.full((2,), s["fs"], device=dev, dtype=torch.int64)
        ev, up, c_ev, c_up = [], [], [], []
        for j in steps:
            x2 = keep["x"][j].float().repeat(2, 1, 1, 1, 1)
            t = torch.full((2,), int(sch["t"][j]), device=dev,
                           dtype=torch.int64)
            r_out = m.eps(x2, t, ctx, z_cond.repeat(2, 1, 1, 1, 1), fs)
            ev.append(rel(keep["out"][j], r_out))
            nxt = refs.step(x2[:1], refs.guide(keep["out"][j],
                                               s["guidance_scale"],
                                               s["guidance_rescale"]),
                            noise[j], sch, j)
            p_next = keep["x"][j + 1] if j + 1 < n_steps else keep["z"]
            up.append(rel(p_next, nxt))
            if ctl is not None:
                c_out = ctl.eps(x2, t, c_ctx, c_zc.repeat(2, 1, 1, 1, 1), fs)
                c_ev.append(rel(c_out, r_out))
                c_nxt = refs.step(x2[:1], refs.guide(
                    c_out, s["guidance_scale"], s["guidance_rescale"]),
                    noise[j], sch, j)
                c_up.append(rel(ref.round_fp8(c_nxt), c_nxt))
        prog["eval"], prog["step"] = max(ev), max(up)
        z = keep["z"].float()
        frames = m.decode(z).clamp(-1, 1)
        prog["decode"] = rel(torch.as_tensor(keep["frames"], device=dev),
                             frames)
        if ctl is not None:
            alt.update(eval=max(c_ev), step=max(c_up), start=0.0,
                       timestep=0.0,
                       decode=rel(ctl.decode(z).clamp(-1, 1), frames))
    limits = cell.workload["limits"]
    return {who: {k: {"value": v, "limit": limits[k]} for k, v in d.items()}
            for who, d in (("program", prog), ("control", alt)) if d}


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _state_unchanged():
    """Each DDIM step runs its eval and returns the state it was given."""
    from open_pandora_tpu_torch.models import dynamicrafter as dc

    def ddim_sample(model_fn, params, x_T, **kw):
        b = x_T.shape[0]
        for idx in range(params.num_steps):
            model_fn(x_T, torch.full((b,), int(params.ts[idx]),
                                     dtype=torch.int64, device=x_T.device))
        return x_T
    return _patched(dc, "ddim_sample", ddim_sample)


def _half_batch():
    """The batched CFG eval runs the first half of its batch only and gives
    that half's output for the whole batch."""
    from open_pandora_tpu_torch.models.dynamicrafter import DynamiCrafter

    real = DynamiCrafter.apply_model

    def apply_model(self, x, t, ctx, zc, fs=None):
        h = x.shape[0] // 2
        out = real(self, x[:h], t[:h], ctx[:h], zc[:h], fs[:h])
        return out.repeat(2, 1, 1, 1, 1)
    return _patched(DynamiCrafter, "apply_model", apply_model)


def _answer_altered():
    """The decode returns the clip with its first frame dimmed by half."""
    from open_pandora_tpu_torch.models.dynamicrafter import DynamiCrafter

    real = DynamiCrafter.decode

    def decode(self, z, frame_chunk=1):
        out = real(self, z, frame_chunk=frame_chunk)
        out[:, 0] *= 0.5
        return out
    return _patched(DynamiCrafter, "decode", decode)


# the faults this cell can have, each breaking the timed path underneath
FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered}


def one_clip(cell) -> tuple:
    """One clip of the cell's first request through the timed path, with
    what the check keeps of it."""
    prog = Program(cell)
    req = cell.traffic.request(0)
    prog.rec.start(req)
    prog.rec.finish(prog.clip(req, cell.config["sampler"]["steps"]))
    out = pick(prog.rec.clips, cell.seed, prog.steps), prog.steps
    del prog
    return out


def calibrate(cell, control: bool = False, faults: bool = False) -> dict:
    """The check's numbers for one seed: the program's, the control's and
    each fault's."""
    keep, steps = one_clip(cell)
    gc.collect()
    out = {k: {n_: v["value"] for n_, v in d.items()}
           for k, d in check(cell, keep, steps, control=control).items()}
    del keep
    if faults:
        for name, fault in FAULTS.items():
            with fault():
                keep, steps = one_clip(cell)
            out[name] = {k: v["value"] for k, v in
                         check(cell, keep, steps)["program"].items()}
            del keep
    return out
