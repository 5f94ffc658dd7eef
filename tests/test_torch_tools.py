"""PyTorch port, tools/ and utils/profiling.py and the latent finetune step
against the JAX package (CPU): every new entry point's --help, and the
vbench and app --debug runs, in a process where importing jax or the JAX
package fails; activation_dump's capture and diff_npz; one
make_latent_finetune_step step; convert_ckpt (a partial PL file, a full
tiny DynamiCrafter and WorldModel round trip into --ckpt, --dry-run);
audit_ckpt_keys' transformers part; the profiling helpers; each tool's
function once on the narrow config."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import save_file

from open_pandora_tpu.core.convert import convert_dynamicrafter, convert_unet
from open_pandora_tpu.models.dynamicrafter import DynamiCrafter as JaxDC
from open_pandora_tpu.models.unet3d import UNetModel as JaxUNet
from open_pandora_tpu.tools import activation_dump as jdump
from open_pandora_tpu.tools import audit_ckpt_keys as jaudit
from open_pandora_tpu.train.optim import trainable_partition
from open_pandora_tpu.train.step import _latent_loss_fn
from open_pandora_tpu.utils import profiling as jprof
from open_pandora_tpu_torch.core.config import PandoraConfig, TrainConfig
from open_pandora_tpu_torch.eval.inference import (build_model, debug_config,
                                                   load_checkpoint)
from open_pandora_tpu_torch.pipeline import cli
from open_pandora_tpu_torch.pipeline.chat_wm import (build_world_model,
                                                     debug_world_config)
from open_pandora_tpu_torch.tools import (activation_dump, audit_ckpt_keys,
                                          clip_ab, convert_ckpt, fused_drift,
                                          hires_train_probe, profile_unet)
from open_pandora_tpu_torch.train.step import (TrainState, diffusion_draws,
                                               make_latent_finetune_step)
from open_pandora_tpu_torch.utils import profiling
from torch_parity import (jax_config, jax_sub_config, max_abs, prefixed,
                          rerandomize_, to_jax)

REPO = Path(__file__).resolve().parent.parent
HW = 32


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- no jax -------------------------------------------------------------------

ENTRY_POINTS = ["eval.vbench", "pipeline.app", "eval.gpt_judge",
                "tools.activation_dump", "tools.profile_unet",
                "tools.clip_ab", "tools.fused_drift",
                "tools.hires_train_probe", "tools.convert_ckpt",
                "tools.audit_ckpt_keys"]

GUARD = """
import contextlib, importlib, io, json, os, sys, types
for m in ("jax", "open_pandora_tpu"):
    sys.modules[m] = None
import numpy as np
import torch
torch.set_num_threads(1)
from PIL import Image
for name in {names!r}:
    mod = importlib.import_module("open_pandora_tpu_torch." + name)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            mod.main(["--help"])
            raise SystemExit("no exit")
        except SystemExit as e:
            assert e.code == 0, (name, e.code)
    assert "usage" in out.getvalue(), name
root = sys.argv[1]
os.makedirs(os.path.join(root, "crop", "8-5"))
Image.fromarray(np.full((40, 48, 3), 90, np.uint8)).save(
    os.path.join(root, "crop", "8-5", "a.png"))
json.dump([{{"image_name": "a.png", "prompt_en": "a car"}}],
          open(os.path.join(root, "vbench2_i2v_full_info.json"), "w"))
from open_pandora_tpu_torch.eval import vbench
assert vbench.main(["--vbench-data", root, "--save-dir", root + "/out",
                    "--n-samples", "2", "--debug", "--device", "cpu"]) == 0
assert sorted(os.listdir(root + "/out")) == ["a car-0.mp4", "a car-1.mp4"]
gr = types.ModuleType("gradio")
class C:
    def __init__(self, *a, **k): pass
    def __enter__(self): return self
    def __exit__(self, *e): return False
    def click(self, fn, inputs, outputs): gr.fns.append(fn)
    def launch(self, **kw): gr.launched = kw
gr.fns = []
for n in ("Blocks", "Row", "Image", "Video", "Slider", "Number", "Textbox",
          "Button", "Markdown"):
    setattr(gr, n, C)
sys.modules["gradio"] = gr
from open_pandora_tpu_torch.pipeline import app
assert app.main(["--debug", "--device", "cpu"]) == 0
assert gr.launched == {{"server_port": 10041, "server_name": "0.0.0.0"}}
assert len(gr.fns) == 6
bad = [m for m in sys.modules if sys.modules[m] is not None
       and m.split(".")[0] in ("jax", "open_pandora_tpu")]
assert not bad, bad
print("guard ok")
"""


def test_entry_points_run_without_jax(tmp_path):
    """Each new entry point answers --help; vbench.main --debug writes its
    two clips and app.main --debug builds its session and its six
    callbacks (a stand-in gradio), where jax and the JAX package cannot
    be imported."""
    done = subprocess.run(
        [sys.executable, "-c", GUARD.format(names=ENTRY_POINTS),
         str(tmp_path / "vb")],
        cwd=REPO, timeout=300, capture_output=True, text=True)
    assert done.returncode == 0, done.stderr[-3000:]
    assert "guard ok" in done.stdout


# -- activation_dump ----------------------------------------------------------


def small_config():
    """debug_config at 2 frames with a one-level UNet: the JAX side's
    capture and jitted gradient take seconds, not tens of seconds."""
    cfg = debug_config(t=2)
    return dataclasses.replace(cfg, unet=dataclasses.replace(
        cfg.unet, model_channels=32, channel_mult=(1,),
        num_head_channels=16))


@pytest.fixture(scope="module")
def tiny_unet():
    ucfg = small_config().unet
    port = activation_dump.build_unet(ucfg, "cpu")
    flat = rerandomize_(port, seed=51)
    jparams = to_jax(convert_unet(prefixed(flat, "u"), jax_sub_config(ucfg),
                                  prefix="u"))
    return ucfg, port, jparams


def test_capture_output_matches_jax(tiny_unet, tmp_path, capsys):
    """The port's __output__ is the JAX capture's on the same weights and
    inputs; the dump holds every tensor-returning module; diff_npz gives
    the JAX diff_npz's rows and lines on the same two dumps."""
    ucfg, port, jparams = tiny_unet
    x, t, ctx = activation_dump.unet_inputs(ucfg, h=8, w=8, device="cpu")
    acts = activation_dump.capture(port, x, t, ctx)
    ref = jdump.capture(JaxUNet(jax_sub_config(ucfg)), jparams,
                        jnp.asarray(x.numpy()), jnp.asarray(t.numpy()),
                        jnp.asarray(ctx.numpy()))
    out, want = acts["__output__"], ref["__output__"]
    assert out.shape == want.shape == (1, ucfg.temporal_length, 8, 8, 4)
    assert np.abs(out - want).max() <= 1e-4 * max(1.0, np.abs(want).max())
    names = {n for n, _ in port.named_modules() if n}
    assert "time_embed.0" in acts and set(acts) - {"__output__"} <= names
    assert all(a.dtype == np.float32 for a in acts.values())
    a = activation_dump.save_npz(str(tmp_path / "a.npz"), acts)
    acts2 = dict(acts, __output__=acts["__output__"] * 1.5)
    acts2["out.2"] = np.zeros((3,), np.float32)
    del acts2["time_embed.0"]
    b = activation_dump.save_npz(str(tmp_path / "b.npz"), acts2)
    capsys.readouterr()
    rows = activation_dump.diff_npz(a, b, top=0)
    ours = capsys.readouterr().out
    assert rows == jdump.diff_npz(a, b, top=0)
    assert ours == capsys.readouterr().out
    assert dict((k, r) for k, r, _ in rows)["__output__"] == \
        pytest.approx(1 / 3)


# -- the latent finetune step -------------------------------------------------

LATENT_TRAIN = dict(learning_rate=1e-4, uncond_prob=0.0, grad_clip_norm=1e9)


def _no_dropout(rate, deterministic=None, **kw):
    return _FlaxDropout(0.0, deterministic=deterministic, **kw)


_FlaxDropout = flax.linen.Dropout


def test_latent_finetune_step_matches_jax():
    """One step over precomputed latents, the JAX draws (t, noise from the
    step's key) injected, dropout off on both sides: the loss, and the
    gradients of every UNet projection (a spatial and a temporal attention
    projection among them)."""
    cfg = small_config()
    port = build_model(cfg, device="cpu")
    flat = rerandomize_(port, seed=52)
    for m in port.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    jc = jax_config(cfg)
    jmodel = JaxDC(jc)
    jparams = jax.tree_util.tree_map(jnp.asarray,
                                     convert_dynamicrafter(flat, jc))
    u, b = cfg.unet, 2
    rng = np.random.default_rng(53)
    zshape = (b, u.temporal_length, HW // 2, HW // 2, cfg.vae.z_channels)
    batch = {"z": rng.standard_normal(zshape).astype(np.float32),
             "ctx": rng.standard_normal(
                 (b, u.text_context_len + u.temporal_length
                  * u.img_tokens_per_frame, u.context_dim)).astype(np.float32),
             "z_cond": rng.standard_normal(zshape).astype(np.float32),
             "fps": np.asarray([8, 3], np.int32)}
    key = jax.random.PRNGKey(54)
    trainable, frozen = trainable_partition(jparams, "dynamicrafter")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout", _no_dropout)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            _latent_loss_fn(jmodel), has_aux=True))(
            trainable, frozen, {k: jnp.asarray(v) for k, v in batch.items()},
            key)
    k_diff, _ = jax.random.split(key)
    t_key, n_key = jax.random.split(k_diff)
    draws = {"t": torch.from_numpy(np.asarray(jax.random.randint(
                 t_key, (b,), 0, cfg.diffusion.timesteps))),
             "noise": torch.from_numpy(np.asarray(jax.random.normal(
                 n_key, zshape)))}
    tcfg = TrainConfig(**LATENT_TRAIN)
    state = TrainState.create(port, "dynamicrafter", tcfg)
    m = make_latent_finetune_step(port, tcfg)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()},
        draws=draws)
    assert abs(float(m["loss"]) - float(loss)) < 1e-5 * float(loss)
    ref = {}
    from open_pandora_tpu_torch.core import convert as tconvert
    tconvert.unet(ref, jax.tree_util.tree_map(np.asarray, grads["unet"]),
                  cfg.unet, "model.diffusion_model")
    got = {k: p.grad for k, p in state.trainable.items()}
    assert got.keys() == ref.keys()
    projections = [k for k in got if k.endswith("attn1.to_q.weight")]
    spatial = [k for k in projections if "transformer_blocks" in k
               and ".1.transformer_blocks" in k]
    assert spatial and len(projections) > len(spatial)
    worst = max(max_abs(got[k], ref[k])
                / max(float(np.abs(ref[k]).max()), 1e-3) for k in got)
    assert worst < 1e-3, worst
    with pytest.raises(ValueError, match="generator or the draws"):
        make_latent_finetune_step(port, tcfg)(state, batch)


def test_latent_step_draws_from_a_generator():
    """Without draws the step makes them through diffusion_draws at z's
    shape (the timesteps and the noise, nothing else): the same generator
    seed gives the same loss."""
    cfg = debug_config()
    losses = []
    for _ in range(2):
        model = build_model(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(55))
        for mod in model.modules():
            if isinstance(mod, torch.nn.Dropout):
                mod.p = 0.0
        tcfg = TrainConfig(**LATENT_TRAIN)
        state = TrainState.create(model, "dynamicrafter", tcfg)
        u = cfg.unet
        z = torch.randn(1, u.temporal_length, 16, 16, 4,
                        generator=torch.Generator().manual_seed(56))
        batch = {"z": z, "z_cond": z, "fps": torch.tensor([8]),
                 "ctx": torch.zeros(1, 15, u.context_dim)}
        losses.append(float(make_latent_finetune_step(model, tcfg)(
            state, batch, generator=torch.Generator().manual_seed(57))
            ["loss"]))
    assert losses[0] == losses[1] and np.isfinite(losses[0])
    draws = diffusion_draws(model, z.shape, torch.Generator().manual_seed(57))
    assert draws.keys() == {"t", "noise"}
    assert draws["t"].shape == (1,) and draws["noise"].shape == z.shape


# -- convert_ckpt -------------------------------------------------------------


def test_convert_partial_checkpoint_fails(tmp_path, capsys):
    """The JAX test_convert_ckpt_cli_dry_run case: a PL file of one
    unknown tensor is read, then refused for its missing keys."""
    ckpt = tmp_path / "part.ckpt"
    torch.save({"state_dict": {"_forward_module.foo.weight":
                               torch.zeros(2, 2)}}, ckpt)
    with pytest.raises(KeyError, match="keys missing"):
        convert_ckpt.main(["--src", str(ckpt), "--dst", str(tmp_path / "o"),
                           "--family", "dynamicrafter", "--dry-run"])
    assert "loaded 1 torch tensors" in capsys.readouterr().out
    assert not (tmp_path / "o").exists()


def test_convert_dynamicrafter_round_trip(tmp_path, capsys):
    """A full tiny DynamiCrafter in the PL dialect (renamed fps keys, an
    unused schedule buffer): --dry-run writes nothing; the conversion
    writes a directory eval/inference.py's --ckpt loads to the same
    tensors."""
    cfg = debug_config()
    src = build_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(58))
    sd = src.state_dict()
    raw = {"_forward_module." + k.replace("fps_embedding",
                                          "framestride_embed"): v
           for k, v in sd.items()}
    raw["_forward_module.betas"] = torch.ones(1000)
    torch.save({"state_dict": raw, "epoch": 3}, tmp_path / "dc.ckpt")
    dst = tmp_path / "converted"
    rep = convert_ckpt.convert(str(tmp_path / "dc.ckpt"), str(dst),
                               "dynamicrafter", dry_run=True, cfg=cfg)
    assert not dst.exists() and rep["unused"] == ["betas"]
    assert rep["leaves"] == len(sd)
    out = capsys.readouterr().out
    assert f"loaded {len(raw)} torch tensors" in out
    assert f"{len(sd)} leaves" in out
    convert_ckpt.convert(str(tmp_path / "dc.ckpt"), str(dst),
                         "dynamicrafter", cfg=cfg)
    model = build_model(cfg, device="cpu")
    load_checkpoint(model, str(dst))
    assert all(torch.equal(v, sd[k]) for k, v in model.state_dict().items())


def test_convert_world_model_into_cli_ckpt(tmp_path):
    """A tiny WorldModel as one .safetensors file, converted, restores
    through the CLI's --ckpt to the same tensors."""
    cfg = debug_world_config()
    sd = {k: v.clone().contiguous() for k, v in build_world_model(
        cfg, device="cpu", generator=torch.Generator().manual_seed(59))
        .state_dict().items()}
    save_file(sd, str(tmp_path / "wm.safetensors"))
    dst = tmp_path / "wm_converted"
    convert_ckpt.convert(str(tmp_path / "wm.safetensors"), str(dst),
                         "world_model", cfg=cfg)
    args = cli.build_parser().parse_args(
        ["--image", "x", "--action", "go", "--debug", "--device", "cpu",
         "--ckpt", str(dst)])
    wm = cli.build_chat(args).wm
    assert all(torch.equal(v, sd[k]) for k, v in wm.state_dict().items())


# -- audit_ckpt_keys ----------------------------------------------------------

HF_FAMILIES = ("video_model.", "diffusion_qformer", "diffusion_proj",
               "diffusion_query_tokens", "image_prefix",
               "diffusion_model.cond_stage_model.",
               "diffusion_model.embedder.")


def test_audit_transformers_part_at_tiny_widths(capsys, tmp_path):
    """The transformers families, open_clip towers and schedule buffers of
    the released surface at the narrow WorldModel's widths: every key is
    loaded by the port's loader or allow-listed, and the WorldModel's
    families hold exactly the rest at the same shapes."""
    cfg = debug_world_config()
    surface = audit_ckpt_keys.hf_surface(cfg)
    rep = audit_ckpt_keys.audit(surface, cfg, only=HF_FAMILIES)
    assert audit_ckpt_keys.report(rep, surface)
    assert "[audit] PASS" in capsys.readouterr().out
    assert rep["consumed"] == rep["model"] and rep["unconsumed"]
    assert not rep["missing"] and not rep["mismatched"]
    # a key the loader would need, taken away, is reported missing
    gone = dict(surface)
    gone.pop("image_prefix.weight")
    assert audit_ckpt_keys.audit(gone, cfg, only=HF_FAMILIES)["missing"] == \
        ["image_prefix.weight"]
    with pytest.raises(FileNotFoundError, match="reference DynamiCrafter"):
        audit_ckpt_keys.lvdm_surface(cfg, str(tmp_path))
    assert audit_ckpt_keys.ALLOWED_UNUSED == jaudit.ALLOWED_UNUSED
    assert audit_ckpt_keys.allowed_unused(PandoraConfig()) == \
        jaudit.ALLOWED_UNUSED


# -- profiling ----------------------------------------------------------------


def test_profiling_helpers(tmp_path, monkeypatch):
    with profiling.trace(str(tmp_path / "tr")) as prof:
        with profiling.annotate("my_region"):
            torch.ones(8).sum()
    assert "my_region" in {e.key for e in prof.key_averages()}
    assert list((tmp_path / "tr").glob("*.json"))
    profiling.sync({"a": [1, torch.ones(2)]})
    profiling.sync(3)
    assert profiling.device_memory_stats() == {}
    clock = iter([0.0, 1.0, 3.0, 6.0, 10.0] * 2)
    summaries = []
    for mod in (profiling, jprof):
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        timer = mod.StepTimer(warmup=1)
        assert timer.summary() == {}
        for _ in range(5):
            timer.tick()
        summaries.append(timer.summary())
        monkeypatch.undo()
    assert summaries[0] == summaries[1]
    assert summaries[0]["n"] == 3 and summaries[0]["mean_s"] == 3.0
    arrays = {"a": np.zeros((3, 4)), "b": {"c": np.zeros(5)}}
    assert profiling.count_params(arrays) == jprof.count_params(arrays) == 17
    lin = torch.nn.Linear(3, 4)
    assert profiling.count_params(lin) == 16
    assert profiling.count_params(lin.state_dict()) == 16


# -- each tool once on the narrow config --------------------------------------


def test_tool_functions_on_the_cpu(tmp_path):
    cfg = debug_config()
    kw = dict(height=HW, width=HW, dtype=torch.float32)
    rep = profile_unet.profile_unet(cfg, "cpu", iters=2, profile=True, **kw)
    assert rep["finite"] and rep["ms_per_cfg_eval"] > 0
    assert rep["shape"] == [2, cfg.unet.temporal_length, 4, 4, 4]
    assert rep["by_class_ms"] == {}        # no device kernels on the CPU
    rep = clip_ab.clip_ab(cfg, "cpu", steps_a=1, steps_b=2, iters=1,
                          n_timed=1, **kw)
    assert rep["finite"] and {"slope_ms_per_step", "one_time_s",
                              "ddim50_projection_s", "eval"} <= rep.keys()
    rep = fused_drift.fused_drift(cfg, "cpu", ddim_steps=2,
                                  fp32_reference=True, **kw)
    # on the CPU both routes are the plain one: the same clip
    assert rep["ddim_steps"] == 2
    assert rep["shape"] == [1, cfg.unet.temporal_length, 16, 16, 4]
    zero = {"max_abs": 0.0, "mean_abs": 0.0, "rel_mean": 0.0}
    for key in ("z", "frames"):
        assert rep[key] == zero
        for route in ("fused", "unfused"):
            assert rep["fp32_reference"][route][key] == zero
    # in bf16 the fp32 reference is the upcast model: each route (the same
    # plain one here) lies a bf16 rounding's distance from it
    rep = fused_drift.fused_drift(cfg, "cpu", ddim_steps=1, height=HW,
                                  width=HW, fp32_reference=True)
    ref = rep["fp32_reference"]
    assert ref["fused"] == ref["unfused"]
    assert 0 < ref["fused"]["z"]["rel_mean"] < 0.1, ref
    path = hires_train_probe.precompute(cfg, "cpu", height=HW, width=HW,
                                        path=str(tmp_path / "lat.npz"))
    data = np.load(path)
    assert data["z"].shape == data["z_cond"].shape == (
        1, cfg.unet.temporal_length, 16, 16, 4)
    assert data["ctx"].shape == (1, 15, cfg.unet.context_dim)
    rep = hires_train_probe.train(cfg, "cpu", latents=path, steps=1,
                                  optimizer="adamw8bit", dtype=torch.float32)
    assert rep["metric"] == "latent_finetune_step_32x32x4f_bs1"
    assert np.isfinite([rep["loss_first"], rep["loss_last"]]).all()
    assert "peak_bytes" not in rep
    out = str(tmp_path / "acts.npz")
    assert activation_dump.main(["--out", out, "--tiny", "--device",
                                 "cpu"]) == 0
    assert activation_dump.main(["--out", "-", "--diff", out, out]) == 0
    assert "__output__" in np.load(out).files
