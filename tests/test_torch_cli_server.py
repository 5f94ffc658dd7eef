"""PyTorch port, the user's entry points against the JAX package (CPU):
pipeline/cli.py (the parser, --debug to an mp4, --ckpt, --quantize-llm
int8 and nf4) and pipeline/server.py (the page, the multipart parser, the
HTTP round trip with an injected generate_fn and with a ChatWM session);
and every module of this slice importing and running where jax, the JAX
package, OpenCV, PIL and pandas cannot be imported."""

import io
import json
import subprocess
import sys
import threading
import types
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from open_pandora_tpu.pipeline import cli as jcli
from open_pandora_tpu.pipeline import server as jserver
from open_pandora_tpu_torch.core.checkpoint import save_params
from open_pandora_tpu_torch.pipeline import cli, server
from open_pandora_tpu_torch.pipeline.chat_wm import (build_world_model,
                                                     debug_world_config)
from open_pandora_tpu_torch.utils.video_io import read_video_frames

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_thread():
    """The models here are tiny: one intra-op thread keeps their ops from
    competing for the cores with the suite's other workers, where eight
    spinning threads each slow every worker down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _png(tmp_path, mode="RGB", hw=(48, 64)) -> str:
    rng = np.random.default_rng(61)
    img = Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8))
    path = str(tmp_path / f"in_{mode}.png")
    img.convert(mode).save(path)
    return path


# -- cli ----------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["--image", "a.png", "--action", "go"],
    ["--image", "a.png", "--action", "go", "--action", "turn", "--out",
     "o.mp4", "--ckpt", "c", "--tokenizer", "t", "--ddim-steps", "7",
     "--ugs", "3.5", "--eta", "0.5", "--fs", "3", "--fps", "12", "--seed",
     "9", "--height", "576", "--width", "1024", "--debug"],
    ["--image", "a.png", "--action", "go", "--quantize-llm"],
    ["--image", "a.png", "--action", "go", "--quantize-llm", "nf4"],
])
def test_parser_matches_jax(argv):
    """Every option the JAX parser has, with its default, parses to the
    same value; the port adds --device (default cuda)."""
    ours = vars(cli.build_parser().parse_args(argv))
    assert ours.pop("device") == "cuda"
    assert ours == vars(jcli.build_parser().parse_args(argv))


@pytest.mark.parametrize("mode", ["int8", "nf4"])
def test_quantize_llm_builds_a_quantized_chat(mode):
    """--quantize-llm on the debug chat: the random float LLaMA quantized
    once its weights exist. Its codes are the JAX package's
    quantize_llama_params of the same float weights, bit for bit, its
    trunk is the JAX quantized trunk's within 1e-4, and the session runs
    a round."""
    import jax
    import jax.numpy as jnp
    from open_pandora_tpu.core.convert import convert_llama
    from open_pandora_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from open_pandora_tpu.models.quant import quantize_llama_params
    from open_pandora_tpu_torch.core.convert import llama as llama_from_jax
    from torch_parity import jax_sub_config

    argv = ["--image", "a.png", "--action", "go", "--debug", "--device",
            "cpu", "--ddim-steps", "1"]
    args = cli.build_parser().parse_args(argv + ["--quantize-llm", mode])
    chat = cli.build_chat(args)
    llama = chat.wm.llama
    assert chat.wm.quantize_llm == llama.quantized == mode
    assert not [n for n, _ in llama.named_parameters()
                if n.startswith("model.layers.") and n.endswith("_proj.weight")
                or n == "lm_head.weight"]
    # the CLIP tower under llama.model keeps its float projections
    assert llama.model.vision_tower.vision_tower.vision_model.encoder \
        .layers[0].self_attn.q_proj.bias is not None
    float_wm = cli.build_chat(cli.build_parser().parse_args(argv)).wm
    flat = {k: v.numpy() for k, v in float_wm.llama.state_dict().items()}
    cfg = chat.wm.cfg.llama
    jparams = quantize_llama_params(convert_llama(flat, cfg.num_layers), mode)
    want = {}
    llama_from_jax(want, jparams, "model")
    got = {k: v for k, v in llama.state_dict().items()
           if not k.startswith(("model.vision_tower.", "model.mm_projector."))}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    x = np.random.default_rng(62).standard_normal(
        (1, 9, cfg.hidden_size)).astype(np.float32)
    ref = np.asarray(JaxLlama(jax_sub_config(cfg), quantized=mode).apply(
        jax.tree_util.tree_map(jnp.asarray, jparams), jnp.asarray(x),
        method=JaxLlama.trunk))
    with torch.no_grad():
        out = llama.trunk(torch.from_numpy(x)).numpy()
    assert np.abs(out - ref).max() <= 1e-4 * max(1.0, np.abs(ref).max())
    frames = cli.run(chat, np.zeros((40, 48, 3), np.uint8) + 90, args)
    assert frames.shape == (4, 32, 32, 3)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "P"])
def test_decode_image_as_jax_session(tmp_path, mode):
    """The JAX session converts the PIL image to RGB before it reads the
    pixels (pipeline/preprocess.py); the CLI decodes to that array."""
    path = _png(tmp_path, mode)
    with Image.open(path) as im:
        ref = np.asarray(im.convert("RGB"))
    out = cli.decode_image(path)
    assert out.dtype == np.uint8 and np.array_equal(out, ref)


def test_debug_main_writes_mp4(tmp_path):
    """Two actions on the tiny config: round 1 keeps none of its 4 frames
    (the last 4 seed round 2), round 2 all 4, as the JAX CLI's debug run
    (tests/test_pipeline.py)."""
    out = tmp_path / "out.mp4"
    assert cli.main(["--image", _png(tmp_path), "--action", "move forward",
                     "--action", "turn left", "--out", str(out), "--debug",
                     "--device", "cpu"]) == 0
    frames, fps = read_video_frames(str(out))
    assert frames.shape == (4, 32, 32, 3) and abs(fps - 8) < 0.5


def _debug_args(*extra):
    return cli.build_parser().parse_args(
        ["--image", "unused", "--action", "go", "--debug", "--device", "cpu",
         *extra])


def test_ckpt_step_dir_and_torch_file(tmp_path):
    """--ckpt takes the trainer's step_<n> directory (its parameters over
    the random ones) and a reference torch checkpoint (wrapped and with
    the PL prefix, normalised and loaded strictly)."""
    cfg = debug_world_config()
    src = build_world_model(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(62))
    sd = src.state_dict()
    unet = {k: v for k, v in sd.items() if ".diffusion_model." in k}
    path = save_params(str(tmp_path / "ckpts"), unet, step=3)
    wm = cli.build_chat(_debug_args("--ckpt", path)).wm
    got = wm.state_dict()
    assert all(torch.equal(got[k], v) for k, v in unet.items())
    # the rest keeps the random weights of seed 0 (matrices differ)
    rest = [k for k in sd if k not in unet and sd[k].ndim == 2]
    assert rest and not any(torch.equal(got[k], sd[k]) for k in rest)

    torch.save({"state_dict": {f"_forward_module.{k}": v
                               for k, v in sd.items()}}, tmp_path / "m.ckpt")
    wm = cli.build_chat(_debug_args("--ckpt", str(tmp_path / "m.ckpt"))).wm
    assert all(torch.equal(v, sd[k]) for k, v in wm.state_dict().items())


# -- server -------------------------------------------------------------------------


def test_page_is_jax_page():
    assert server.PAGE == jserver.PAGE


def _handler(body: bytes, ctype: str):
    return types.SimpleNamespace(
        headers={"Content-Type": ctype, "Content-Length": str(len(body))},
        rfile=io.BytesIO(body))


def _multipart(boundary: str, fields) -> bytes:
    parts = [f'--{boundary}\r\nContent-Disposition: form-data; '
             f'name="{k}"\r\n\r\n'.encode() + v + b"\r\n"
             for k, v in fields]
    return b"".join(parts) + f"--{boundary}--\r\n".encode()


@pytest.mark.parametrize("boundary,fields,ctype", [
    ("XB", [("image", b"\x89PNGFAKE"), ("actions", b"drive\nturn left"),
            ("seed", b"42")], "multipart/form-data; boundary=XB"),
    # a binary upload ending in CR LF '-' keeps its own trailing bytes
    ("zz", [("image", b"\x00\x01\r\n-"), ("ugs", b"3.5")],
     'multipart/form-data; boundary="zz"; charset=utf-8'),
    ("q", [("image", b"--q-not-a-boundary\r\n\r\n"), ("empty", b"")],
     "multipart/form-data; boundary=q"),
])
def test_parse_multipart_matches_jax(boundary, fields, ctype):
    body = _multipart(boundary, fields)
    ours = server._parse_multipart(_handler(body, ctype))
    assert ours == jserver._parse_multipart(_handler(body, ctype))
    assert ours["image"] == dict(fields)["image"] or boundary == "q"


def test_parse_multipart_refuses_non_multipart():
    for parse in (server._parse_multipart, jserver._parse_multipart):
        with pytest.raises(ValueError, match="not multipart"):
            parse(_handler(b"x", "text/plain"))


@pytest.fixture()
def serving():
    calls = {}

    def fake(image_bytes, actions, **kw):
        calls.update(image=image_bytes, actions=actions, kw=kw)
        return b"MP4" + actions[0].encode()

    srv = server.make_server(fake, port=0, host="127.0.0.1")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv, calls, f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    thread.join()


def _post(base, body, boundary):
    req = urllib.request.Request(base + "/generate", data=body, headers={
        "Content-Type": f"multipart/form-data; boundary={boundary}"})
    return urllib.request.urlopen(req, timeout=120)


def test_health_page_and_generate(serving):
    _, calls, base = serving
    with urllib.request.urlopen(base + "/health") as r:
        assert json.load(r) == {"status": "ok"}
    with urllib.request.urlopen(base + "/") as r:
        assert r.read().decode() == server.PAGE
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(base + "/nope")
    assert e.value.code == 404
    body = _multipart("B", [("image", b"\x89PNG\r\n-"),
                            ("actions", b" drive \n\nturn left\n"),
                            ("ddim_steps", b"7"), ("ugs", b"3.5"),
                            ("eta", b"0.5"), ("fs", b""), ("seed", b"42")])
    with _post(base, body, "B") as r:
        assert r.headers["Content-Type"] == "video/mp4"
        assert r.read() == b"MP4drive"
    assert calls == {"image": b"\x89PNG\r\n-", "actions": ["drive",
                                                           "turn left"],
                     "kw": {"ddim_steps": 7, "ugs": 3.5, "eta": 0.5,
                            "seed": 42}}


def test_error_is_json_500(serving):
    srv, _, base = serving

    def boom(image_bytes, actions, **kw):
        raise RuntimeError("no card")
    srv.RequestHandlerClass.generate_fn = staticmethod(boom)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, _multipart("B", [("image", b"x")]), "B")
    assert e.value.code == 500
    assert json.load(e.value) == {"error": "no card"}


def test_chatwm_generate_fn_serves_mp4(tmp_path):
    """The server around a tiny ChatWM session (CPU): a PNG upload and two
    actions come back as an mp4 of the session's 4 frames, equal in shape
    to cli.run's on the same image."""
    chat = cli.build_chat(_debug_args())
    srv = server.make_server(server.chatwm_generate_fn(chat), port=0,
                             host="127.0.0.1")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        with open(_png(tmp_path), "rb") as f:
            body = _multipart("B", [("image", f.read()),
                                    ("actions", b"go\nturn"),
                                    ("ddim_steps", b"2"), ("seed", b"5")])
        with _post(f"http://127.0.0.1:{srv.server_address[1]}", body,
                   "B") as r:
            data = r.read()
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join()
    (tmp_path / "got.mp4").write_bytes(data)
    frames, _ = read_video_frames(str(tmp_path / "got.mp4"))
    assert frames.shape == (4, 32, 32, 3)
    assert len(chat.round_times) == 2


# -- no jax, no optional packages -------------------------------------------------------

NEW_MODULES = ["native", "pipeline.cli", "pipeline.server",
               "utils.image_grid", "utils.loggers", "utils.video_io",
               "data.webvid", "data.sft", "train.trainer", "models.unet3d",
               "core.flags", "core.checkpoint", "models.quant",
               "models.llama_generate", "models.eva_tower",
               "eval.chatunivi_qa", "eval.scienceqa", "eval.consistency"]

GUARD = """
import io, json, sys, threading, urllib.request
for m in ("jax", "open_pandora_tpu", "cv2", "PIL", "pandas"):
    sys.modules[m] = None
import numpy as np
import torch
torch.set_num_threads(1)
{imports}
from open_pandora_tpu_torch.pipeline import cli, server
from open_pandora_tpu_torch.utils import image_grid, video_io
srv = server.make_server(lambda *a, **k: b"", port=0, host="127.0.0.1")
threading.Thread(target=srv.serve_forever, daemon=True).start()
url = "http://127.0.0.1:%d/health" % srv.server_address[1]
assert json.load(urllib.request.urlopen(url)) == {{"status": "ok"}}
srv.shutdown(); srv.server_close()
args = cli.build_parser().parse_args(["--image", "x", "--action", "go",
    "--action", "turn", "--debug", "--device", "cpu"])
frames = cli.run(cli.build_chat(args),
                 np.zeros((40, 48, 3), np.uint8) + 100, args)
assert frames.shape == (4, 32, 32, 3), frames.shape
image_grid.save_sample_grid(sys.argv[1], frames[None])
for call, name in ((lambda: video_io.write_video("o.mp4", frames), "cv2"),
                   (lambda: cli.decode_image("x.png"), "PIL")):
    try:
        call()
        raise SystemExit("no ImportError")
    except ImportError as e:
        assert name in str(e), e
assert not video_io.HAVE_CV2
from open_pandora_tpu_torch.eval import chatunivi_qa, consistency, scienceqa
wm, tok, _, _ = chatunivi_qa.setup_model(debug=True, device="cpu",
                                         quantize_llm="nf4")
img = np.zeros((40, 48, 3), np.uint8) + 50
rec = chatunivi_qa.answer_question(wm, tok, {{"id": 1, "text": "hi"}}, img, 3)
assert len(rec["answer"].split()) == 3, rec
rec = scienceqa.answer_question(wm, tok, {{"id": "s", "conversations": [
    {{"value": "(A) a (B) b"}}]}}, img, max_new_tokens=2)
assert rec["pred"] in "AB", rec
rec = consistency.answer_sample(wm, tok, {{"video_name": "v", "Q1": "a",
    "Q2": "b", "A": "c"}}, np.stack([img] * 4), 0, max_new_tokens=2)
assert rec["text_1"] and rec["text_2"], rec
bad = [m for m in sys.modules if sys.modules[m] is not None
       and m.split(".")[0] in ("jax", "open_pandora_tpu", "cv2", "PIL",
                               "pandas")]
assert not bad, bad
print("guard ok")
"""


def test_new_modules_need_neither_jax_nor_optional_packages(tmp_path):
    """In a process where jax, the JAX package, OpenCV, PIL and pandas
    cannot be imported: every module of these slices imports, the server
    answers /health, cli.run runs a two-round --debug session on the CPU
    and its sample grid is written (the stdlib PNG); writing an mp4 and
    decoding an image raise ImportError naming the package; each answer
    runner's core answers on an NF4 debug WorldModel."""
    imports = "\n".join(f"import open_pandora_tpu_torch.{m}"
                        for m in NEW_MODULES)
    png = tmp_path / "grid.png"
    done = subprocess.run(
        [sys.executable, "-c", GUARD.format(imports=imports), str(png)],
        cwd=REPO, timeout=300, capture_output=True, text=True)
    assert done.returncode == 0, done.stderr[-3000:]
    assert "guard ok" in done.stdout
    with Image.open(png) as im:
        assert im.size == (4 * 32, 32)
