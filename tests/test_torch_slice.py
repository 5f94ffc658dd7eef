"""PyTorch port, the image-to-video slice end to end against the JAX package
(tiny config, fp32, CPU): text and image conditioning, VAE conditioning
latents, DDIM-3 with batched CFG 7.5, eta 1.0 and guidance_rescale 0.7, and
the chunked decode. The JAX x_T and per-step noise are injected into the
port, so the two trajectories see the same draws."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_pandora_tpu.core.convert import convert_dynamicrafter
from open_pandora_tpu.models.dynamicrafter import DynamiCrafter as JaxDC
from open_pandora_tpu_torch.eval.inference import build_model, debug_config
from open_pandora_tpu_torch.models.encoders import empty_prompt_tokens
from torch_parity import jax_config, max_abs, rerandomize_

STEPS, CFG, ETA, RESCALE, FS = 3, 7.5, 1.0, 0.7, 3
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def both():
    cfg = debug_config()
    port = build_model(cfg, device="cpu")
    flat = rerandomize_(port, seed=11)
    jmodel = JaxDC(jax_config(cfg))
    jparams = jax.tree_util.tree_map(
        jnp.asarray, convert_dynamicrafter(flat, jax_config(cfg)))
    rng = np.random.default_rng(12)
    inputs = {
        "ids": np.concatenate([empty_prompt_tokens(1, 7).numpy()[:, :1],
                               rng.integers(1, 49000, (1, 5)),
                               np.full((1, 1), 49407)], axis=1),
        "image": rng.random((1, 40, 48, 3), np.float32),     # [0, 1]
        "frames": rng.uniform(-1, 1, (1, 1, 32, 32, 3)).astype(np.float32),
    }
    key = jax.random.PRNGKey(5)
    text = jmodel.encode_text(jparams, jnp.asarray(inputs["ids"], jnp.int32))
    z = jmodel.image_guided_synthesis(
        jparams, text_context=text, cond_images=jnp.asarray(inputs["image"]),
        cond_frames=jnp.asarray(inputs["frames"]), key=key,
        ddim_steps=STEPS, guidance_scale=CFG, eta=ETA, fs=FS,
        guidance_rescale=RESCALE)
    video = jmodel.decode(jparams, z, frame_chunk=2)
    # the draws image_guided_synthesis made from `key`
    k_noise, k_samp = jax.random.split(key)
    shape = z.shape
    draws = {
        "x_T": np.array(jax.random.normal(k_noise, shape)),
        "noise": [np.array(jax.random.normal(jax.random.fold_in(k_samp, i),
                                             shape))
                  for i in range(STEPS)],
    }
    ref = {"text": np.asarray(text), "z": np.asarray(z),
           "video": np.asarray(video)}
    return port, inputs, draws, ref


def test_text_context_matches(both):
    port, inputs, _, ref = both
    with torch.no_grad():
        text = port.encode_text(torch.from_numpy(inputs["ids"]))
    assert max_abs(text, ref["text"]) < 1e-4


def test_synthesis_and_decode_match(both):
    port, inputs, draws, ref = both
    with torch.no_grad():
        text = port.encode_text(torch.from_numpy(inputs["ids"]))
        z = port.image_guided_synthesis(
            text_context=text, cond_images=torch.from_numpy(inputs["image"]),
            cond_frames=torch.from_numpy(inputs["frames"]), ddim_steps=STEPS,
            guidance_scale=CFG, eta=ETA, fs=FS, guidance_rescale=RESCALE,
            x_T=torch.from_numpy(draws["x_T"]),
            noise=[torch.from_numpy(n) for n in draws["noise"]])
        video = port.decode(z, frame_chunk=2)
    assert z.shape == ref["z"].shape == (1, 4, 16, 16, 4)
    assert np.isfinite(ref["z"]).all() and np.abs(ref["z"]).max() > 0.1
    # fp32 on both sides. One UNet eval agrees to ~3e-6 of its scale
    # (summation order); CFG 7.5 weighs the streams' difference by 7.5 and
    # three steps compound it, measured 1.0e-4 of the latents' scale. Bound:
    # 5e-4 of the scale, for the latents and the decoded frames.
    scale = float(np.abs(ref["z"]).max())
    assert max_abs(z, ref["z"]) < 5e-4 * scale
    assert video.shape == ref["video"].shape == (1, 4, 32, 32, 3)
    assert max_abs(video, ref["video"]) < 5e-4 * max(
        1.0, float(np.abs(ref["video"]).max()))


def test_cli_debug_run(tmp_path):
    """The CLI end to end on the CPU, prompt dir in and mp4 out, in a
    process where importing jax fails: main() and its file IO stay
    jax-free."""
    from PIL import Image

    from open_pandora_tpu.utils.video_io import probe_video

    prompts = tmp_path / "prompts"
    prompts.mkdir()
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 256, (40, 60, 3), dtype=np.uint8)).save(
        prompts / "car.png")
    (prompts / "prompts.txt").write_text("a car drives forward\n")
    argv = ["--prompt-dir", str(prompts), "--save-dir",
            str(tmp_path / "out"), "--device", "cpu", "--debug"]
    code = ("import sys; sys.modules['jax'] = None; "
            "from open_pandora_tpu_torch.eval.inference import main; "
            f"assert main({argv!r}) == 0; "
            "assert 'jax' not in [m.split('.')[0] for m in sys.modules "
            "if sys.modules[m] is not None]")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=300)
    frames, _ = probe_video(str(tmp_path / "out" / "car.mp4"))
    assert frames == 4


@pytest.mark.parametrize("files, txt", [
    (["b_dog.png", "a_cat.JPG", "notes.md"], "first\nsecond\n"),
    (["b_dog.png", "a_cat.jpg"], "only one line\n"),
    (["red_car.webp"], None),
])
def test_prompt_list_matches(tmp_path, files, txt):
    from open_pandora_tpu.eval.inference import load_prompt_list as jax_list
    from open_pandora_tpu_torch.eval.inference import load_prompt_list

    for name in files:
        (tmp_path / name).write_bytes(b"")
    if txt is not None:
        (tmp_path / "prompts.txt").write_text(txt)
    assert load_prompt_list(str(tmp_path)) == jax_list(str(tmp_path))
