"""Stable Video Diffusion XT in the port (models/svd.py, the VideoDecoder
of models/vae.py, diffusion/edm.py, the pooled ViT-H readout) against the
plain float32 reference tests/svd_reference.py, on seeded random weights
at a tiny size: the video blocks at two frame counts, the preconditioned
denoiser with its vector conditioning, the decoder over an uneven chunking,
the sigmas and the start latent (exact), a whole 3-step clip through
`eval.inference.synthesize`, both readouts of the ViT tower, and the
CLI's path to `--model svd_xt`."""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import svd_reference as R
from open_pandora_tpu_torch.core.config import SVDConfig, model_config
from open_pandora_tpu_torch.diffusion import edm
from open_pandora_tpu_torch.eval import inference
from open_pandora_tpu_torch.models import unet3d
from open_pandora_tpu_torch.models.encoders import CLIPVisionEncoder
from open_pandora_tpu_torch.models.vae import decode_video_chunks
from open_pandora_tpu_torch.ops import kernels
from open_pandora_tpu_torch.utils import profiling

HERE = os.path.dirname(os.path.abspath(__file__))


def rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def ref_config(cfg: SVDConfig) -> dict:
    d = {k: dataclasses.asdict(getattr(cfg, k))
         for k in ("video_unet", "vae", "clip_image", "edm")}
    d["cond_scale_factor"] = cfg.cond_scale_factor
    return d


@pytest.fixture(scope="module")
def pair():
    """(port model, reference model) of the tiny configuration, fp32, with
    the same seeded weights, matched by name."""
    torch.manual_seed(0)
    cfg = inference.debug_svd_config()
    m = inference.build_model(cfg, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    with torch.device("meta"):
        r = R.SVD(ref_config(cfg))
    r = r.to_empty(device="cpu")
    ps, rs = dict(m.named_parameters()), dict(r.named_parameters())
    assert set(ps) == set(rs)
    with torch.no_grad():
        for k, v in rs.items():
            v.copy_(ps[k])
    return m, r


def _blocks(pair, kind):
    m, r = pair
    if kind == "resblock":
        return m.model.diffusion_model.input_blocks[1][0], \
            r.model.diffusion_model.input_blocks[1][0], 32
    return m.model.diffusion_model.input_blocks[1][1], \
        r.model.diffusion_model.input_blocks[1][1], 32


@pytest.mark.parametrize("t", [3, 5])
@pytest.mark.parametrize("kind", ["resblock", "video_transformer"])
def test_video_blocks_match_reference(pair, kind, t):
    port, ref, c = _blocks(pair, kind)
    g = torch.Generator().manual_seed(t)
    b = 2
    x = torch.randn(b * t, 8, 8, c, generator=g)
    with torch.no_grad(), R.fp32_exact():
        if kind == "resblock":
            emb = torch.randn(b, 128, generator=g).repeat_interleave(t, 0)
            got, want = port(x, emb, b), ref(x, emb, b)
        else:
            ctx = torch.randn(b, 1, 32, generator=g).repeat_interleave(t, 0)
            got, want = port(x, ctx, b), ref(x, ctx, b)
    assert rel(got, want) < 1e-5


@pytest.mark.parametrize("sigma", [700.0, 3.7, 0.002])
def test_denoiser_matches_reference(pair, sigma):
    m, r = pair
    g = torch.Generator().manual_seed(1)
    img = torch.rand(1, 32, 32, 3, generator=g)
    frame = img * 2 - 1 + 0.02 * torch.randn(1, 32, 32, 3, generator=g)
    x = torch.randn(2, 4, 16, 16, 4, generator=g)
    with torch.no_grad(), R.fp32_exact():
        cp, cr = m.conditioning(img, frame), r.conditioning(img, frame)
        for k in ("context", "concat", "vector"):
            assert rel(cp[k], cr[k]) < 1e-5, k
        assert torch.equal(cp["vector"], cr["vector"])
        got = m.denoise(x, torch.tensor(sigma), cp)
        want = r.denoise(x, torch.tensor(sigma), cr)
    assert rel(got, want) < 1e-5


def test_decoder_over_uneven_chunks(pair):
    m, r = pair
    g = torch.Generator().manual_seed(2)
    z = torch.randn(1, 5, 4, 4, 4, generator=g)
    r.cfg["edm"].decoding_t = 3
    try:
        with torch.no_grad(), R.fp32_exact():
            got = decode_video_chunks(m.first_stage_model.decoder, z,
                                      scale_factor=0.18215, chunk=3)
            want = r.decode(z)
            whole = decode_video_chunks(m.first_stage_model.decoder, z,
                                        scale_factor=0.18215, chunk=5)
    finally:
        r.cfg["edm"].decoding_t = m.cfg.edm.decoding_t
    assert got.shape == (1, 5, 8, 8, 3)
    assert rel(got, want) < 1e-5
    # the chunk is the time stack's video: another chunking is another clip
    assert rel(whole, want) > 1e-3


def test_sigmas_start_and_guidance_exact():
    s = SVDConfig().edm
    got = edm.karras_sigmas(s.steps, s.sigma_min, s.sigma_max, s.rho)
    want = R.karras_sigmas(s.steps, s.sigma_min, s.sigma_max, s.rho)
    assert torch.equal(got, want) and got.shape == (31,)
    assert float(got[-1]) == 0.0 and abs(float(got[0]) - 700.0) < 1e-2
    d = torch.randn(2, 25, 3, 3, 4)
    assert torch.equal(edm.guide(d, edm.guidance_scale(1.5, 3.0, 25)),
                       R.guide(d, 1.5, 3.0))


def test_synthesize_matches_reference(pair):
    """A 3-step clip through the entry point against the reference's, from
    the same generator draws (the frame's cond_aug noise, then the start
    latent)."""
    m, r = pair
    rng = np.random.default_rng(0)
    image = rng.integers(0, 256, (40, 60, 3), dtype=np.uint8)
    seed = 2 ** 31 + 5
    got = inference.synthesize(m, image, "ignored", height=32, width=32,
                               ddim_steps=3,
                               generator=torch.Generator().manual_seed(seed))
    assert got.shape == (1, 4, 32, 32, 3)
    from open_pandora_tpu_torch.pipeline.preprocess import (
        diffusion_preprocess)
    with torch.no_grad(), R.fp32_exact():
        gen = torch.Generator().manual_seed(seed)
        frame = diffusion_preprocess(torch.from_numpy(image), (32, 32))[None]
        noise = torch.randn(frame.shape, generator=gen)
        cond = r.conditioning((frame + 1) / 2, frame + 0.02 * noise)
        sig = R.karras_sigmas(3, 0.002, 700.0, 7.0)
        x = R.start((1, 4, 16, 16, 4), sig[0], gen, "cpu")
        assert torch.equal(m.sigmas(3), sig)
        want = r.decode(R.sample(r, cond, x, sig)).clamp(-1, 1)
    assert rel(torch.from_numpy(got), want) < 1e-4


def test_start_latent_is_the_seeds_draw(pair, monkeypatch):
    m, _ = pair
    seen = {}
    real = edm.edm_sample

    def spy(denoise, x, sigmas, scale):
        seen["x"] = x.clone()
        return real(denoise, x, sigmas[-2:], scale)
    monkeypatch.setattr(edm, "edm_sample", spy)
    cond = {"context": torch.zeros(2, 1, 32), "vector": torch.zeros(2, 24),
            "concat": torch.zeros(2, 16, 16, 4)}
    gen = torch.Generator().manual_seed(9)
    m.sample(cond, generator=gen, steps=3)
    want = R.start((1, 4, 16, 16, 4), R.karras_sigmas(3, 0.002, 700.0,
                                                      7.0)[0],
                   torch.Generator().manual_seed(9), "cpu")
    assert torch.equal(seen["x"], want)


@pytest.mark.parametrize("readout", ["tokens", "pooled"])
def test_vit_readouts(pair, readout):
    """The pooled readout matches the reference; the token readout of the
    same tower is DynamiCrafter's, unchanged: a CLIPVisionEncoder with the
    same weights gives the same 257-token stream (here 5 tokens)."""
    m, r = pair
    tower = m.conditioner.embedders["0"].open_clip.model.visual
    rtower = r.conditioner.embedders["0"].open_clip.model.visual
    x = torch.randn(2, 28, 28, 3, generator=torch.Generator().manual_seed(4))
    with torch.no_grad(), R.fp32_exact():
        if readout == "pooled":
            assert rel(tower.pooled(x), rtower.pooled(x)) < 1e-5
            return
        dc = CLIPVisionEncoder(tower.cfg)
        sd = {k: v for k, v in tower.state_dict().items()
              if not k.startswith(("ln_post", "proj"))}
        dc.load_state_dict(sd, strict=True)
        assert torch.equal(dc(x), tower(x))
        assert not any(k.startswith(("ln_post", "proj"))
                       for k in dc.state_dict())


def test_video_transformer_on_the_fused_route(pair, monkeypatch):
    """On the fused route (faked on the CPU: the kernels' plain versions)
    both feed-forwards take row 13 (one call each) and the block's output
    is the unfused route's, within bf16."""
    port, _, c = _blocks(pair, "video_transformer")
    blk = port.time_stack[0].to(torch.bfloat16)
    try:
        x = torch.randn(2, 5, 6, c, generator=torch.Generator().manual_seed(7)
                        ).to(torch.bfloat16)
        ctx = torch.randn(2, 1, 32).to(torch.bfloat16)
        with torch.no_grad():
            eager = blk(x, ctx)
            calls = []
            real = unet3d.fused_geglu_ff
            monkeypatch.setattr(unet3d, "fused_geglu_ff",
                                lambda *a, **k: calls.append(1) or real(*a,
                                                                        **k))
            monkeypatch.setattr(kernels, "fused_available", lambda t: True)
            assert rel(blk(x, ctx), eager) < 2e-2
            assert len(calls) == 2
    finally:
        blk.float()


def test_full_width_eval_routes_as_chip_smoke_checks(monkeypatch):
    """svd_xt's VideoUNet at 576x1024x25, one bf16 CFG eval on the meta
    device with the launchers stubbed: its launches are chip_smoke's
    SVD_EVAL_LAUNCHES, and phase 3 checks row 13 at every feed-forward's
    rows and row 2 at every attention it takes."""
    import math

    import chip_smoke
    from test_torch_fused_ops import _spy_unet

    from open_pandora_tpu_torch.models import svd
    from open_pandora_tpu_torch.ops import fused_geglu

    calls = _spy_unet(monkeypatch)
    monkeypatch.setattr(kernels, "fused_available", lambda x: True)
    rows, small = set(), set()
    spy_ff, spy_attention = fused_geglu._geglu_cuda, unet3d.attention

    def ff(x2, *params):
        rows.add(tuple(x2.shape))
        return spy_ff(x2, *params)

    def attention(q, k, v, **kw):
        out = spy_attention(q, k, v, **kw)
        if calls[-1] == "small":
            small.add((*q.shape[:2], k.shape[1], *q.shape[2:]))
        return out
    monkeypatch.setattr(fused_geglu, "_geglu_cuda", ff)
    monkeypatch.setattr(unet3d, "attention", attention)
    u = SVDConfig().video_unet
    with torch.device("meta"):
        model = svd.VideoUNet(u).to(torch.bfloat16)
    model.eval()

    def meta(*shape):
        return torch.empty(*shape, dtype=torch.bfloat16, device="meta")
    with torch.no_grad():
        out = model(meta(2, u.num_frames, 72, 128, u.in_channels),
                    torch.zeros(2, device="meta"), meta(2, 1, u.context_dim),
                    meta(2, u.adm_in_channels))
    assert out.shape == (2, u.num_frames, 72, 128, u.out_channels)
    got = {k: calls.count(k) for k in chip_smoke.KERNEL_KEYS}
    assert got == {k: chip_smoke.SVD_EVAL_LAUNCHES.get(k, 0)
                   for k in chip_smoke.KERNEL_KEYS}
    assert rows <= {(math.prod(x[:-1]), x[-1])
                    for _, x in chip_smoke.SVD_GEGLU_SITES}
    assert len(rows) == 4
    assert small <= {case[:5] for case in chip_smoke.SVD_SMALL_CASES}
    assert len(small) == 4


def test_spans_of_a_traced_clip(pair):
    m, _ = pair
    from torch.profiler import ProfilerActivity, profile
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        inference.synthesize(m, np.zeros((32, 32, 3), np.uint8), "",
                             height=32, width=32, ddim_steps=2,
                             generator=torch.Generator().manual_seed(0))
    names = {s["name"] for s in profiling.spans()}
    profiling.clear()
    assert {"unet", "unet.resblock", "unet.time_stack", "unet.spatial",
            "unet.video_transformer", "edm.step", "edm.eval",
            "edm.guidance", "edm.update", "vae.video_decode"} <= names


def test_cli_chooses_svd_xt(tmp_path):
    args = inference.build_parser().parse_args(
        ["--prompt-dir", "p", "--save-dir", "o", "--model", "svd_xt"])
    cfg, dtype, h, w, steps = inference.run_settings(args)
    assert isinstance(cfg, SVDConfig) and cfg == model_config("svd_xt")
    assert (dtype, h, w, steps) == (torch.bfloat16, 576, 1024, 30)
    args = inference.build_parser().parse_args(
        ["--prompt-dir", "p", "--save-dir", "o"])
    assert inference.run_settings(args)[2:] == (320, 512, 50)
    with pytest.raises(KeyError):
        model_config("nope")
    from PIL import Image
    prompts = tmp_path / "prompts"
    prompts.mkdir()
    Image.fromarray(np.full((40, 60, 3), 90, np.uint8)).save(
        prompts / "car.png")
    assert inference.main(["--model", "svd_xt", "--debug", "--device", "cpu",
                           "--prompt-dir", str(prompts), "--save-dir",
                           str(tmp_path / "out")]) == 0
    assert (tmp_path / "out" / "car.mp4").stat().st_size > 0


def test_reference_imports_neither_jax_nor_the_port():
    src = open(os.path.join(HERE, "svd_reference.py")).read()
    assert "open_pandora_tpu" not in src.split('"""', 2)[2]
    assert "jax" not in src.split('"""', 2)[2]
    assert "svd_reference" in sys.modules


def test_server_answers_with_an_svd_clip(tmp_path):
    """`--model svd_xt` on the server: an upload answered with one clip's
    mp4 (the tiny configuration on the CPU, a local port)."""
    import argparse
    import io
    import threading
    import urllib.request

    from PIL import Image

    from open_pandora_tpu_torch.pipeline import server
    from open_pandora_tpu_torch.utils.video_io import probe_video

    args = argparse.Namespace(model="svd_xt", debug=True, device="cpu",
                              ckpt=None)
    srv = server.make_server(server.build_i2v(args), port=0,
                             host="127.0.0.1")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        png = io.BytesIO()
        Image.fromarray(np.full((40, 60, 3), 70, np.uint8)).save(png, "PNG")
        body = (b"--XB\r\nContent-Disposition: form-data; name=\"image\"; "
                b"filename=\"a.png\"\r\n\r\n" + png.getvalue() + b"\r\n"
                b"--XB\r\nContent-Disposition: form-data; "
                b"name=\"ddim_steps\"\r\n\r\n2\r\n--XB--\r\n")
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/generate", data=body,
            headers={"Content-Type": "multipart/form-data; boundary=XB"})
        with urllib.request.urlopen(req, timeout=120) as r:
            mp4 = r.read()
    finally:
        srv.shutdown()
        srv.server_close()
    out = tmp_path / "svd.mp4"
    out.write_bytes(mp4)
    assert probe_video(str(out))[0] == 4
