"""Stable Video Diffusion XT image-to-video clips through the port's entry,
`eval.inference.synthesize` (an SVD model runs `synthesize_svd`), one
client in a closed loop: clip after clip, each with its own image and
sampler seed (the request's prompt is not read: SVD takes no text), at the
configuration's frame size, frames and EDM steps, in bf16.

Set-up: the model in bf16 on the card with the benchmark's weights, the
kernel library built or loaded, one clip of two Euler steps (the
conditioning, two batched-CFG evals, the whole decode in its chunks: every
shape of the cell). Window: clips back to back until `seconds` have
passed; it closes when the last started clip ends. A recorder at
`denoise` and `decode` keeps what the timed path produced (the latent and
the denoiser's output at the steps the check reads, the conditioning, each
eval's sigma, the decoded latents); the returned frames are kept too. The
record has the shape of entries/i2v.py's, so the i2v metric readers apply.

Check, after the window, with the program freed: one clip drawn from the
seed, held to the float32 reference (benchmark/reference/svd.py), which
works the conditioning out again from the request and the sampler seed
and follows the program's own latents at three steps drawn from the seed
(the first, the last and one between): the conditioning (the pooled image
embedding and the concat latent of the noised frame), the start latent and
the sigmas (exact), the batched-CFG denoiser output at each drawn step,
the guider and Euler update from the program's own output, and the
VideoDecoder on the latents the program decoded, in its chunks.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

import flops_svd
from entries.i2v import (PEAK_BF16, WARMUP_INDEX, _patched, check_steps,
                         rel)
from reference import model as refm
from reference import svd as ref
from traffic.generator import np_seed

NUMBERS = ("cond", "start", "sigmas", "eval", "step", "decode")


def port_config(config: dict):
    """The program's SVDConfig from the configuration file."""
    from open_pandora_tpu_torch.core import config as pc

    groups = {"video_unet": pc.VideoUNetConfig, "vae": pc.VAEConfig,
              "clip_image": pc.CLIPImageEmbedConfig,
              "edm": pc.EDMSamplerConfig}
    kw = {key: cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in config[key].items()})
          for key, cls in groups.items()}
    return pc.SVDConfig(cond_scale_factor=config["cond_scale_factor"], **kw)


class Recorder:
    """Wraps the model's `denoise` and `decode` (instance attributes) to
    keep, per clip, what the timed path produced: the conditioning of the
    first eval; at the steps of `keep` the latent in and the denoiser's
    output, and the latent after them; every eval's sigma; the latents
    decoded. Copies stay on the device. `on_eval(n)` is called after the
    n-th eval of a clip."""

    def __init__(self, model, keep):
        self.clips, self.cur, self.keep = [], None, set(keep)
        self.on_eval = None
        real_denoise, real_decode = model.denoise, model.decode

        def denoise(x, sigma, cond):
            out = real_denoise(x, sigma, cond)
            c = self.cur
            if c is not None:
                j = c["n"]
                if j == 0:
                    c["cond"] = {k: v.clone() for k, v in cond.items()}
                if j in self.keep or j - 1 in self.keep:
                    c["x"][j] = x[:x.shape[0] // 2].clone()
                if j in self.keep:
                    c["out"][j] = out.clone()
                c["sigma"].append(sigma.reshape(1))
                c["n"] = j + 1
                if self.on_eval is not None:
                    self.on_eval(j + 1)
            return out

        def decode(z):
            if self.cur is not None:
                self.cur["z"] = z.clone()
            return real_decode(z)

        model.denoise, model.decode = denoise, decode

    def start(self, request):
        self.cur = {"request": request, "x": {}, "out": {}, "sigma": [],
                    "n": 0}

    def finish(self, frames):
        c = self.cur
        c["frames"], c["sigma"] = frames, torch.cat(c["sigma"]).tolist()
        self.clips.append(c)
        self.cur = None


class Program:
    """The program under test, set up for a cell: the model in bf16 with the
    benchmark's weights, the kernel library, the recorder."""

    def __init__(self, cell):
        from open_pandora_tpu_torch.eval.inference import build_model
        from open_pandora_tpu_torch.ops import kernels
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
        self.steps = check_steps(cell.seed, cell.config["edm"]["steps"])
        self.rec = Recorder(self.model, self.steps)

    def clip(self, req, steps, timings=None):
        from open_pandora_tpu_torch.eval.inference import synthesize

        v = self.cell.config["video"]
        gen = torch.Generator(device=self.dev).manual_seed(req["noise_seed"])
        return synthesize(self.model, req["image"], req["prompt"],
                          height=v["height"], width=v["width"],
                          ddim_steps=steps, generator=gen, timings=timings)


def pick(clips: list, seed: int) -> dict:
    """One finished clip drawn from the seed: what the recorder kept."""
    rng = np.random.default_rng(np_seed(seed, 7))
    c = clips[int(rng.integers(len(clips)))]
    return {k: c[k] for k in ("cond", "sigma", "z", "frames", "request",
                              "x", "out", "n")}


def run(cell) -> dict:
    s = cell.config["edm"]
    prog = Program(cell)
    rec, traffic = prog.rec, cell.traffic
    # warm-up: every shape of the cell, the conditioning, two evals, decode
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
    dev = cell.device
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
        record["flops_per_item"] = flops_svd.svd_clip(cell.config)
        record["peak_flops"] = PEAK_BF16

    # -- the check, with the program freed ------------------------------------
    keep, steps = pick(rec.clips, cell.seed), prog.steps
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
        m = ref.SVD(config, refm.Numerics(fp8=fp8))
    m = m.to_empty(device=device)
    params = dict(m.named_parameters())
    shapes = {k: tuple(p.shape) for k, p in params.items()}
    with torch.no_grad():
        for name, v in weights.values(shapes, seed, device):
            params[name].copy_(v.float())
    return m


@torch.no_grad()
def conditioning(m, config: dict, req: dict, gen: torch.Generator) -> dict:
    """The request's streams, from its image and the first draw of the
    sampler's generator (the cond_aug noise of the frame)."""
    v, dev = config["video"], m.device
    frame = refm.diffusion_frame(req["image"].to(dev).float() / 255.0,
                                 (v["height"], v["width"]))[None]
    noise = torch.randn(frame.shape, generator=gen, device=dev,
                        dtype=torch.float32)
    return m.conditioning((frame + 1.0) / 2.0,
                          frame + config["edm"]["cond_aug"] * noise)


@torch.no_grad()
def check(cell, keep: dict, steps, control: bool = False) -> dict:
    """The numbers compared, each with its limit, of the program against the
    float32 reference; with `control`, also of the control (the reference
    with every product's operands in fp8, its latent carried in fp8) put in
    the program's place on the program's own latents."""
    cfgj, dev = cell.config, cell.device
    s, v = cfgj["edm"], cfgj["video"]
    req, n = keep["request"], keep["n"]
    m = reference_model(cfgj, cell.seed, dev)
    ctl = reference_model(cfgj, cell.seed, dev, fp8=True) if control else None
    prog, alt = {}, {}
    with refm.fp32_exact():
        gen = torch.Generator(device=dev).manual_seed(req["noise_seed"])
        cond = conditioning(m, cfgj, req, gen)
        kc = keep["cond"]
        prog["cond"] = max(rel(kc["context"], cond["context"]),
                           rel(kc["concat"], cond["concat"]))
        sig = ref.karras_sigmas(s["steps"], s["sigma_min"], s["sigma_max"],
                                s["rho"], device=dev)
        f = 2 ** (len(cfgj["vae"]["channel_mult"]) - 1)
        shape = (1, v["frames"], v["height"] // f, v["width"] // f,
                 cfgj["vae"]["z_channels"])
        x0 = ref.start(shape, sig[0], gen, dev)
        prog["start"] = float((keep["x"][0] - x0).abs().max())
        prog["sigmas"] = float(max(abs(keep["sigma"][j] - float(sig[j]))
                                   for j in range(n)))
        if ctl is not None:
            gc_ = torch.Generator(device=dev).manual_seed(req["noise_seed"])
            c_cond = conditioning(ctl, cfgj, req, gc_)
            alt["cond"] = max(rel(c_cond["context"], cond["context"]),
                              rel(c_cond["concat"], cond["concat"]))
        ev, up, c_ev, c_up = [], [], [], []
        for j in steps:
            x = keep["x"][j]
            r_out = m.denoise(torch.cat([x, x]), sig[j], cond)
            ev.append(rel(keep["out"][j], r_out))
            nxt = ref.euler(x, ref.guide(keep["out"][j],
                                         s["min_guidance_scale"],
                                         s["max_guidance_scale"]),
                            sig[j], sig[j + 1])
            p_next = keep["x"][j + 1] if j + 1 < n else keep["z"]
            up.append(rel(p_next, nxt))
            if ctl is not None:
                c_out = ctl.denoise(torch.cat([x, x]), sig[j], c_cond)
                c_ev.append(rel(c_out, r_out))
                c_nxt = ref.euler(x, ref.guide(c_out,
                                               s["min_guidance_scale"],
                                               s["max_guidance_scale"]),
                                  sig[j], sig[j + 1])
                c_up.append(rel(refm.round_fp8(c_nxt), c_nxt))
        prog["eval"], prog["step"] = max(ev), max(up)
        z = keep["z"].float()
        frames = m.decode(z).clamp(-1, 1)
        prog["decode"] = rel(torch.as_tensor(keep["frames"], device=dev),
                             frames)
        if ctl is not None:
            alt.update(eval=max(c_ev), step=max(c_up), start=0.0, sigmas=0.0,
                       decode=rel(ctl.decode(z).clamp(-1, 1), frames))
    limits = cell.workload["limits"]
    return {who: {k: {"value": val, "limit": limits[k]}
                  for k, val in d.items()}
            for who, d in (("program", prog), ("control", alt)) if d}


def _state_unchanged():
    """Each Euler step runs its eval and returns the state it was given."""
    from open_pandora_tpu_torch.diffusion import edm

    def edm_sample(denoise, x, sigmas, scale):
        for i in range(len(sigmas) - 1):
            denoise(torch.cat([x, x]), sigmas[i])
        return x
    return _patched(edm, "edm_sample", edm_sample)


def _half_batch():
    """The batched CFG eval runs the first half of its batch only (the
    unconditional streams) and gives that half's output for the whole
    batch."""
    from open_pandora_tpu_torch.models.svd import StableVideoDiffusion

    real = StableVideoDiffusion.denoise

    def denoise(self, x, sigma, cond):
        h = x.shape[0] // 2
        out = real(self, x[:h], sigma, {k: c[:h] for k, c in cond.items()})
        return out.repeat(2, 1, 1, 1, 1)
    return _patched(StableVideoDiffusion, "denoise", denoise)


def _answer_altered():
    """The decode returns the clip with its first frame dimmed by half."""
    from open_pandora_tpu_torch.models.svd import StableVideoDiffusion

    real = StableVideoDiffusion.decode

    def decode(self, z):
        out = real(self, z)
        out[:, 0] *= 0.5
        return out
    return _patched(StableVideoDiffusion, "decode", decode)


# the faults this cell can have, each breaking the timed path underneath
FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered}


def one_clip(cell) -> tuple:
    """One clip of the cell's first request through the timed path, with
    what the check keeps of it."""
    prog = Program(cell)
    req = cell.traffic.request(0)
    prog.rec.start(req)
    prog.rec.finish(prog.clip(req, cell.config["edm"]["steps"]))
    out = pick(prog.rec.clips, cell.seed), prog.steps
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
