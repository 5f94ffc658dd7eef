"""Gradio web app: the reference's UI (gradio_app.py).

Counterpart of open_pandora_tpu/pipeline/app.py: a Blocks app on port
10041 with five per-round action buttons, a multi-action button and
sliders for fs, guidance, DDIM steps and eta, and the seed
(gradio_app.py:35-84, 200-212). gradio is imported inside `build_app`
only; without it `main` prints the CLI to use and returns 2, as the JAX
app does. The two callbacks are module-level (`round_fn`, `multi_fn`),
so they run without gradio; they take the UI's PIL image as
pipeline/cli.decode_image reads a file (RGB, uint8) and write the clip
under the temporary directory (`tempfile.gettempdir()`, /tmp unless
TMPDIR says otherwise; the JAX app writes to /tmp).

  python -m open_pandora_tpu_torch.pipeline.app [--ckpt PATH]
      [--tokenizer DIR] [--port 10041] [--debug] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np


def _rgb(img) -> np.ndarray:
    """The UI's PIL image -> uint8 RGB (H, W, 3), as cli.decode_image."""
    return np.asarray(img.convert("RGB"))


def _out(name: str) -> str:
    return os.path.join(tempfile.gettempdir(), name)


def round_fn(chat, i: int):
    """The callback of the button of round i + 1: round 0 starts the
    session on the image, later rounds chain the last clip."""
    def fn(img, text, fs, ugs, steps, eta, seed):
        kw = dict(ddim_steps=int(steps), fs=int(fs),
                  guidance_scale=float(ugs), eta=float(eta), seed=int(seed))
        if i == 0:
            chat.generate_video(_rgb(img), text, **kw)
        else:
            chat.generate_video_next_round(text, **kw)
        return chat.save_video(_out(f"pandora_round{i}.mp4"))
    return fn


def multi_fn(chat):
    """The multi-action callback: the non-empty actions of the five
    boxes, one round each."""
    def fn(img, *args_):
        texts = [t for t in args_[:5] if t]
        fs_, ugs_, steps_, eta_, seed_ = args_[5:]
        chat.generate_video_multiround(
            _rgb(img), texts, ddim_steps=int(steps_), fs=int(fs_),
            guidance_scale=float(ugs_), eta=float(eta_), seed=int(seed_))
        return chat.save_video(_out("pandora_multi.mp4"))
    return fn


def build_app(chat):
    import gradio as gr

    with gr.Blocks(title="Open-Pandora") as demo:
        gr.Markdown("# Open-Pandora — interactive world model")
        with gr.Row():
            image_in = gr.Image(type="pil", label="Conditioning image")
            video_out = gr.Video(label="Generated video")
        with gr.Row():
            fs = gr.Slider(1, 30, value=15, step=1, label="FS")
            ugs = gr.Slider(1.0, 15.0, value=4.0, step=0.5,
                            label="Guidance scale")
            steps = gr.Slider(1, 60, value=50, step=1, label="DDIM steps")
            eta = gr.Slider(0.0, 1.0, value=1.0, step=0.1, label="DDIM eta")
            seed = gr.Number(value=123, label="Seed", precision=0)
        actions = [gr.Textbox(label=f"Action round {i+1}") for i in range(5)]

        for i, a in enumerate(actions):
            btn = gr.Button(f"Generate round {i+1}")
            btn.click(round_fn(chat, i),
                      inputs=[image_in, a, fs, ugs, steps, eta, seed],
                      outputs=[video_out])

        multi = gr.Button("Multi-Action (all rounds)")
        multi.click(multi_fn(chat), inputs=[image_in, *actions, fs, ugs,
                                            steps, eta, seed],
                    outputs=[video_out])
    return demo


def main(argv=None) -> int:
    p = argparse.ArgumentParser("open-pandora-app")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--port", type=int, default=10041)  # gradio_app.py:214
    p.add_argument("--debug", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    try:
        import gradio  # noqa: F401
    except ImportError:
        print("gradio is not installed in this environment; use the CLI:\n"
              "  python -m open_pandora_tpu_torch.pipeline.cli --help",
              file=sys.stderr)
        return 2

    from open_pandora_tpu_torch.pipeline.cli import build_chat

    ns = argparse.Namespace(debug=args.debug, ckpt=args.ckpt,
                            tokenizer=args.tokenizer, height=320, width=512,
                            ddim_steps=50, device=args.device,
                            quantize_llm=False)
    chat = build_chat(ns)
    build_app(chat).launch(server_port=args.port, server_name="0.0.0.0")
    return 0


if __name__ == "__main__":
    sys.exit(main())
