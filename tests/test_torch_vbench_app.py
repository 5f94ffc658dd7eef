"""PyTorch port, eval/vbench.py and pipeline/app.py against the JAX package
(CPU): the vbench parser; vbench.main --debug on one tmp VBench directory
against JAX vbench.main (1 item, 2 samples, the same weights and the JAX
draws injected: the same file names and per-item lines, frames within the
ChatWM test's uint8 step); the slicing and the calls of both mains on stub
sessions; the app's layout, wiring and callbacks against JAX's build_app
(both under a stand-in gradio module that records what is built); and
app.main without gradio."""

import json
import os
import sys
import types

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from open_pandora_tpu.eval import vbench as jvbench
from open_pandora_tpu.pipeline import app as japp
from open_pandora_tpu.pipeline import chat_wm as jchat
from open_pandora_tpu.pipeline.tokenizers import \
    HashFallbackTokenizer as JaxTokenizer
from open_pandora_tpu_torch.eval import vbench
from open_pandora_tpu_torch.pipeline import app, cli
from open_pandora_tpu_torch.pipeline import preprocess as tpre
from open_pandora_tpu_torch.pipeline.chat_wm import ChatWM
from test_torch_world_slice import make_world

H = W = 32
STEPS = 2
PROMPT = "a red car drives along the coast"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vbench_dir(tmp_path, items, hw=(40, 48)):
    root = tmp_path / "vbench"
    crop = root / "crop" / "8-5"
    crop.mkdir(parents=True)
    rng = np.random.default_rng(91)
    for m in items:
        Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
                        ).save(crop / m["image_name"])
    (root / vbench.META_FILE).write_text(json.dumps(items))
    return str(root)


@pytest.mark.parametrize("argv", [
    ["--vbench-data", "d", "--save-dir", "o"],
    ["--vbench-data", "d", "--save-dir", "o", "--ckpt", "c", "--tokenizer",
     "t", "--img-crop", "1-1", "--ddim-steps", "7", "--fs", "3",
     "--n-samples", "2", "--ugs", "3.5", "--eta", "0.5", "--start-id", "4",
     "--end-id", "9", "--height", "576", "--width", "1024", "--debug"],
    ["--vbench-data", "d", "--save-dir", "o", "--quantize-llm"],
    ["--vbench-data", "d", "--save-dir", "o", "--quantize-llm", "nf4"],
])
def test_parser_matches_jax(argv):
    ours = vars(vbench.build_parser().parse_args(argv))
    assert ours.pop("device") == "cuda"
    assert ours == vars(jvbench.build_parser().parse_args(argv))


def _draws(seed, shape):
    """x_T and the per-step noise the JAX round draws from
    PRNGKey(seed) (sample s of vbench is round 0 at seed s)."""
    k_noise, k_samp = jax.random.split(jax.random.PRNGKey(seed))
    return dict(
        x_T=torch.from_numpy(np.array(jax.random.normal(k_noise, shape))),
        noise=[torch.from_numpy(np.array(jax.random.normal(
            jax.random.fold_in(k_samp, i), shape))) for i in range(STEPS)])


def test_debug_main_matches_jax(tmp_path, monkeypatch, capsys):
    """Both mains on one VBench directory, their sessions built on the same
    weights (make_world); the JAX tower preprocessing replaced by the
    port's and the crop at the frame size, as tests/test_torch_chat_wm.py
    runs the session (PIL's resizes differ from the port's by about one
    uint8 step; its preprocessing tests hold them)."""
    cfg, jmodel, params, port = make_world(seed=81)
    data = _vbench_dir(tmp_path, [{"image_name": "a.png",
                                   "prompt_en": PROMPT}], hw=(H, W))
    saved = {"jax": {}, "port": {}}

    class JChat(jchat.ChatWM):
        def save_video(self, path, frames=None, fps=8):
            saved["jax"][os.path.basename(path)] = frames
            return super().save_video(path, frames, fps)

    shape = (1, cfg.unet.temporal_length, H // 2, W // 2,
             cfg.vae.z_channels)

    class TChat(ChatWM):
        def generate_video(self, image, text, *, seed=0, **kw):
            return super().generate_video(image, text, seed=seed, **kw,
                                          **_draws(seed, shape))

        def save_video(self, path, frames=None, fps=8):
            saved["port"][os.path.basename(path)] = frames
            return super().save_video(path, frames, fps)

    monkeypatch.setenv("PANDORA_CACHE_DIR", "off")
    monkeypatch.setattr(jchat, "clip_tower_preprocess",
                        lambda img, size: tpre.clip_tower_preprocess(
                            np.asarray(img), size).numpy())
    monkeypatch.setattr(jvbench, "_build_chat", lambda args: JChat(
        jmodel, params, tokenizer=JaxTokenizer(), height=H, width=W))
    monkeypatch.setattr(cli, "build_chat",
                        lambda args: TChat(port, height=H, width=W))
    argv = ["--vbench-data", data, "--n-samples", "2", "--ddim-steps",
            str(STEPS), "--debug"]
    out = {}
    for tag, main, extra in (("jax", jvbench.main, []),
                             ("port", vbench.main, ["--device", "cpu"])):
        capsys.readouterr()
        assert main(argv + ["--save-dir", str(tmp_path / tag)] + extra) == 0
        out[tag] = [ln for ln in capsys.readouterr().out.splitlines()
                    if ln.startswith("[vbench]")]
    names = [f"{PROMPT}-0.mp4", f"{PROMPT}-1.mp4"]
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax")) == names
    assert out["port"] == out["jax"] == ["[vbench] a.png: 2 samples"]
    for n in names:
        ref, got = saved["jax"][n], saved["port"][n]
        assert got.shape == ref.shape == (cfg.unet.temporal_length, H, W, 3)
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1, n
    assert not np.array_equal(saved["port"][names[0]],
                              saved["port"][names[1]])


class StubChat:
    """Records what a harness asks of the session."""

    def __init__(self):
        self.calls = []

    def generate_video(self, image, text, **kw):
        self.calls.append(("generate_video", np.asarray(image.convert("RGB"))
                           if hasattr(image, "convert") else image, text, kw))
        return np.full((4, 8, 8, 3), len(self.calls), np.uint8)

    def generate_video_next_round(self, text, **kw):
        self.calls.append(("generate_video_next_round", text, kw))

    def generate_video_multiround(self, image, texts, **kw):
        self.calls.append(("generate_video_multiround",
                           np.asarray(image.convert("RGB"))
                           if hasattr(image, "convert") else image, texts,
                           kw))

    def save_video(self, path, frames=None, fps=8):
        self.calls.append(("save_video", os.path.basename(path),
                           None if frames is None else int(frames[0, 0, 0,
                                                                  0]), fps))
        return path


def _same_calls(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert len(x) == len(y) and x[0] == y[0]
        for u, v in zip(x[1:], y[1:]):
            if isinstance(u, np.ndarray):
                np.testing.assert_array_equal(u, v)
            else:
                assert u == v


@pytest.mark.parametrize("extra", [
    ["--n-samples", "1"],
    ["--n-samples", "3", "--start-id", "1", "--end-id", "3", "--ugs", "2.5",
     "--fs", "5", "--eta", "0.3", "--ddim-steps", "9"]])
def test_main_calls_match_jax(tmp_path, monkeypatch, capsys, extra):
    """The same slice of the metadata, images, prompts, sampler settings,
    seeds and file names through both mains, on stub sessions."""
    items = [{"image_name": f"{i}.png", "prompt_en": f"prompt {i}"}
             for i in range(4)]
    data = _vbench_dir(tmp_path, items)
    chats = {"jax": StubChat(), "port": StubChat()}
    monkeypatch.setenv("PANDORA_CACHE_DIR", "off")
    monkeypatch.setattr(jvbench, "_build_chat", lambda args: chats["jax"])
    monkeypatch.setattr(cli, "build_chat", lambda args: chats["port"])
    lines = {}
    for tag, main, device in (("jax", jvbench.main, []),
                              ("port", vbench.main, ["--device", "cpu"])):
        capsys.readouterr()
        assert main(["--vbench-data", data, "--save-dir",
                     str(tmp_path / tag)] + device + extra) == 0
        lines[tag] = capsys.readouterr().out
    _same_calls(chats["port"].calls, chats["jax"].calls)
    assert lines["port"] == lines["jax"]
    assert len(chats["port"].calls) == 2 * len(lines["port"].splitlines()) \
        * int(extra[1])


def test_run_yields_names_without_io():
    """The core on its own: no file is read or written."""
    args = vbench.build_parser().parse_args(
        ["--vbench-data", "-", "--save-dir", "-", "--n-samples", "2",
         "--start-id", "1"])
    chat = StubChat()
    items = [{"image_name": "x", "prompt_en": "p0"},
             {"image_name": "y", "prompt_en": "p1"}]
    images = {"y": np.zeros((4, 4, 3), np.uint8)}
    got = [name for name, _ in vbench.run(chat, items, images, args)]
    assert got == ["p1-0.mp4", "p1-1.mp4"]
    assert [c[3]["seed"] for c in chat.calls] == [0, 1]


# -- the app ------------------------------------------------------------------


def _fake_gradio():
    """A stand-in gradio: each component records its constructor's
    arguments, each click its callback and the positions of its inputs
    and outputs among the components."""
    mod = types.ModuleType("gradio")
    mod.built, mod.clicks = [], []

    class Component:
        def __init__(self, *a, **k):
            mod.built.append(self)
            self.record = (type(self).__name__, a, k)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def click(self, fn, inputs, outputs):
            pos = {id(c): i for i, c in enumerate(mod.built)}
            mod.clicks.append((mod.built.index(self), fn,
                               [pos[id(c)] for c in inputs],
                               [pos[id(c)] for c in outputs]))

        def launch(self, **kw):
            mod.launched = kw

    for name in ("Blocks", "Row", "Image", "Video", "Slider", "Number",
                 "Textbox", "Button", "Markdown"):
        setattr(mod, name, type(name, (Component,), {}))
    return mod


def _build(build_app, chat, monkeypatch):
    gr = _fake_gradio()
    monkeypatch.setitem(sys.modules, "gradio", gr)
    build_app(chat)
    return gr


def test_app_layout_matches_jax(monkeypatch):
    """The same components with the same arguments (but the page's title
    and heading), in the same order, wired the same way."""
    ref = _build(japp.build_app, StubChat(), monkeypatch)
    ours = _build(app.build_app, StubChat(), monkeypatch)
    strip = [c.record for c in ours.built if c.record[0] not in
             ("Blocks", "Markdown")]
    assert strip == [c.record for c in ref.built
                     if c.record[0] not in ("Blocks", "Markdown")]
    assert [c.record[0] for c in ours.built[:2]] == \
        [c.record[0] for c in ref.built[:2]] == ["Blocks", "Markdown"]
    assert [(b, i, o) for b, _, i, o in ours.clicks] == \
        [(b, i, o) for b, _, i, o in ref.clicks]
    assert len(ours.clicks) == 6


def test_app_callbacks_match_jax(monkeypatch):
    """Each of the six callbacks of both apps, called with the UI's values
    (a PIL RGBA image, floats from the sliders), makes the same calls on
    the session; the port passes the image as uint8 RGB and writes under
    the temporary directory."""
    img = Image.fromarray(np.random.default_rng(92).integers(
        0, 256, (24, 30, 4), dtype=np.uint8), "RGBA")
    chats = {"jax": StubChat(), "port": StubChat()}
    built = {"jax": _build(japp.build_app, chats["jax"], monkeypatch),
             "port": _build(app.build_app, chats["port"], monkeypatch)}
    ui = (15.0, 4.5, 3.0, 0.5, 7.0)           # fs, ugs, steps, eta, seed
    for tag, gr in built.items():
        for i in range(5):
            gr.clicks[i][1](img, f"action {i}", *ui)
        gr.clicks[5][1](img, "go", "", "turn", "", "stop", *ui)
    _same_calls(chats["port"].calls, chats["jax"].calls)
    gen = chats["port"].calls[0]
    assert gen[1].dtype == np.uint8 and gen[1].shape == (24, 30, 3)
    assert gen[3] == dict(ddim_steps=3, fs=15, guidance_scale=4.5, eta=0.5,
                          seed=7)
    assert chats["port"].calls[-2][2] == ["go", "turn", "stop"]
    # the direct callbacks are the ones the app wires
    direct = StubChat()
    app.round_fn(direct, 1)(img, "x", *ui)
    app.multi_fn(direct)(img, "a", "", "", "", "", *ui)
    assert [c[0] for c in direct.calls] == [
        "generate_video_next_round", "save_video",
        "generate_video_multiround", "save_video"]
    saved = app.round_fn(StubChat(), 0)(img, "x", *ui)
    assert os.path.dirname(saved) == __import__("tempfile").gettempdir()


def test_app_main_without_gradio(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "gradio", None)
    assert japp.main(["--debug"]) == 2
    ref = capsys.readouterr().err
    assert app.main(["--debug", "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert err == ref.replace("open_pandora_tpu.", "open_pandora_tpu_torch.")
    assert "open_pandora_tpu_torch.pipeline.cli" in err
