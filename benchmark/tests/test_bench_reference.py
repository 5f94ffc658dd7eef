"""The plain reference against the program's plain route (a CPU tensor
takes it) at tiny widths, on the same weights, in float32; its parameter
names and shapes against the program's at the benchmark's configurations;
and that it imports nothing of the program."""

import ast
import glob
import json
import os

import pytest
import torch

from conftest import BENCH, HERE

import weights
from entries.i2v import port_config, reference_model
from reference import model as ref

SEED = 2 ** 31 + 99


def rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.fixture(scope="module")
def pair():
    from open_pandora_tpu_torch.eval.inference import build_model

    cfg = json.load(open(os.path.join(HERE, "tiny.json")))
    prog = build_model(port_config(cfg), device="cpu")
    weights.fill_(prog, SEED)
    return cfg, prog, reference_model(cfg, SEED, torch.device("cpu"))


@pytest.mark.parametrize("name", ["dynamicrafter_512", "dynamicrafter_1024",
                                  "tiny"])
def test_parameters_match_the_program(name):
    from open_pandora_tpu_torch.models.dynamicrafter import DynamiCrafter

    path = (os.path.join(HERE, "tiny.json") if name == "tiny"
            else os.path.join(BENCH, "configs", name + ".json"))
    cfg = json.load(open(path))
    with torch.device("meta"):
        a = {k: tuple(v.shape) for k, v in
             DynamiCrafter(port_config(cfg)).named_parameters()}
        b = {k: tuple(v.shape) for k, v in
             ref.DynamiCrafter(cfg).named_parameters()}
    assert a == b


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(BENCH, "reference", "*.py")):
        for node in ast.walk(ast.parse(open(path).read())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else [node.module])
                assert not any(n and n.split(".")[0].startswith(
                    ("open_pandora", "jax", "flax")) for n in names), path


@torch.no_grad()
def test_reference_matches_the_plain_route(pair):
    cfg, prog, m = pair
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(1, 49000, (2, cfg["clip_text"]["context_length"]),
                        generator=g)
    assert rel(m.encode_text(ids), prog.encode_text(ids)) < 1e-5
    img = torch.rand(2, 40, 48, 3, generator=g)
    assert rel(m.encode_image(img), prog.encode_image_context(img)) < 1e-5
    frame = torch.rand(1, 32, 32, 3, generator=g) * 2 - 1
    assert rel(m.encode_frame(frame), prog.get_latent_z(frame[:, None])) < 1e-5
    u, t = cfg["unet"], cfg["video"]["frames"]
    x = torch.randn(2, t, 4, 4, 4, generator=g)
    zc = torch.randn(2, t, 4, 4, 4, generator=g)
    ctx = torch.randn(2, u["text_context_len"] + t * u["img_tokens_per_frame"],
                      u["context_dim"], generator=g)
    ts, fs = torch.tensor([999, 999]), torch.tensor([24, 24])
    assert rel(m.eps(x, ts, ctx, zc, fs),
               prog.apply_model(x, ts, ctx, zc, fs)) < 1e-5
    assert rel(m.decode(x[:1]), prog.decode(x[:1])) < 1e-5


def test_fp8_rounding():
    x = torch.linspace(-3, 3, 1001)
    q = ref.round_fp8(x)
    assert q.dtype == x.dtype and float((q - x).abs().max()) <= 3 / 16
    assert rel(q, x) > 1e-3
