"""PyTorch port, the ChatWM session against the JAX package's (tiny config,
fp32, CPU, DDIM-2 with the JAX draws injected): two rounds, uint8 frames in
and out; the preprocessing against the JAX package's PIL preprocessing; the
text buckets; and a debug run in a process where importing `jax` or
`open_pandora_tpu` fails."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from open_pandora_tpu.pipeline import chat_wm as jchat
from open_pandora_tpu.pipeline import preprocess as jpre
from open_pandora_tpu.pipeline.tokenizers import \
    HashFallbackTokenizer as JaxTokenizer
from open_pandora_tpu.utils import video_io as jvio
from open_pandora_tpu_torch.pipeline import preprocess as tpre
from open_pandora_tpu_torch.pipeline.chat_wm import ChatWM
from open_pandora_tpu_torch.pipeline.tokenizers import (
    HashFallbackTokenizer, LlamaTokenizerAdapter, load_tokenizer)
from open_pandora_tpu_torch.utils import video_io as tvio
from test_torch_world_slice import make_world
from torch_parity import max_abs

REPO = Path(__file__).resolve().parent.parent
STEPS, SEED, H, W = 2, 3, 32, 32
TEXTS = ["the camera moves forward slowly", "turn left at the red door"]


def _draws(seed, shape):
    """x_T and the per-step noise image_guided_synthesis draws from
    PRNGKey(seed)."""
    k_noise, k_samp = jax.random.split(jax.random.PRNGKey(seed))
    return dict(
        x_T=torch.from_numpy(np.array(jax.random.normal(k_noise, shape))),
        noise=[torch.from_numpy(np.array(jax.random.normal(
            jax.random.fold_in(k_samp, i), shape))) for i in range(STEPS)])


@pytest.fixture(scope="module")
def sessions():
    """Both packages' two-round sessions on the same weights and image. The
    JAX session's tower preprocessing is replaced by the port's (PIL rounds
    to uint8 after its resize; test_clip_tower_preprocess holds the two
    together), and the port's round 2 starts from the JAX session's round-1
    frames: the two may differ by one uint8 step, and the clustering of the
    frames that re-enter is discontinuous, so a single step can move a
    token to another cluster. Both sessions then see the same inputs in
    each round; the chaining itself is held by the tests below."""
    cfg, jmodel, params, port = make_world(seed=41)
    image = np.random.default_rng(42).integers(0, 256, (H, W, 3),
                                               dtype=np.uint8)
    mp = pytest.MonkeyPatch()
    mp.setattr(jchat, "clip_tower_preprocess",
               lambda img, size: tpre.clip_tower_preprocess(
                   np.asarray(img), size).numpy())
    try:
        jsession = jchat.ChatWM(jmodel, params, tokenizer=JaxTokenizer(),
                                height=H, width=W)
        kw = dict(ddim_steps=STEPS, seed=SEED)
        ref = [jsession.generate_video(Image.fromarray(image), TEXTS[0],
                                       **kw),
               jsession.generate_video_next_round(TEXTS[1], **kw)]
    finally:
        mp.undo()
    chat = ChatWM(port, height=H, width=W)
    shape = (1, cfg.unet.temporal_length, H // 2, W // 2, cfg.vae.z_channels)
    out = [chat.generate_video(image, TEXTS[0], **kw, **_draws(SEED, shape))]
    assert np.abs(out[0].astype(int) - ref[0].astype(int)).max() <= 1
    chat.round_videos[-1] = ref[0]
    out.append(chat.generate_video_next_round(TEXTS[1], **kw,
                                              **_draws(SEED + 1, shape)))
    return chat, jsession, out, ref


def test_two_round_frames_match(sessions):
    chat, jsession, out, ref = sessions
    for got, want in zip(out, ref):
        assert got.dtype == want.dtype == np.uint8
        assert got.shape == want.shape == (4, H, W, 3)
        assert want.std() > 5                         # not a constant clip
        # fp32 on both sides; truncation to uint8 may flip one step
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert (out[0] != out[1]).any()


def test_session_state_matches(sessions):
    chat, jsession, out, ref = sessions
    assert chat.round == jsession.round == 2
    assert len(chat.images) == len(jsession.images) == 1 + 4
    kinds = [type(s).__name__ for s in chat.prompt.segments]
    assert kinds == [type(s).__name__ for s in jsession.prompt.segments]
    assert kinds == ["TokenSegment", "ImageSegment", "TokenSegment",
                     "PrefixSegment", "VideoSegment", "TokenSegment",
                     "PrefixSegment"]
    assert chat.prompt.segments[4].indices == (1, 2, 3, 4)
    for a, b in zip(chat.prompt.segments, jsession.prompt.segments):
        if hasattr(a, "ids"):
            np.testing.assert_array_equal(a.ids.numpy(), np.asarray(b.ids))
    # per round: the conditioning's parts, the sampler, the decode
    assert len(chat.round_times) == 2
    assert {"conditioning_s", "tower_s", "cluster_s", "prefill_s",
            "connector_s", "encoders_s", "sampling_s", "step_s", "decode_s",
            "prompt_len"} == set(chat.round_times[1])
    assert chat.round_times[1]["prompt_len"] > chat.round_times[0][
        "prompt_len"]
    video = tvio.concat_rounds(chat.round_videos)
    assert video.shape == (4, H, W, 3)     # 4-frame rounds: all overlap


def test_next_round_conditions_on_the_last_four_frames(sessions, monkeypatch):
    chat = sessions[0]
    seen = {}
    real = chat.wm.diffusion.synthesis_streams

    def spy(**kw):
        seen.update(kw)
        return real(**kw)
    monkeypatch.setattr(chat.wm.diffusion, "synthesis_streams", spy)
    # a clip longer than the conditioning window, so "the last four" is
    # not "all four"
    last = np.concatenate([chat.round_videos[-1],
                           chat.round_videos[-1][::-1] // 2])
    chat.round_videos[-1] = last
    chat.generate_video_next_round("go on", ddim_steps=1, seed=SEED)
    want = last[-4:].astype(np.float32) / 127.5 - 1.0
    assert seen["cond_frames"].shape == (1, 4, H, W, 3)
    np.testing.assert_array_equal(seen["cond_frames"][0].numpy(), want)
    assert seen["cond_images"] is chat.cond_image      # round 1's image
    assert chat.round == 3 and len(chat.images) == 1 + 4 + 8
    assert chat.prompt.segments[-3].indices == tuple(range(5, 13))


@pytest.mark.parametrize("n_words,bucket", [(3, 16), (15, 16), (16, 32),
                                            (100, 128), (300, 301)])
def test_text_buckets(sessions, n_words, bucket):
    chat, jsession = sessions[0], sessions[1]
    text = " ".join(f"w{i}" for i in range(n_words))
    ids, mask = chat._ids(text, add_bos=True)
    jids, jmask = jsession._ids(text, add_bos=True)
    assert ids.shape == mask.shape == (1, bucket)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert int(mask.sum()) == n_words + 1


# -- preprocessing, video frames, tokenizers --------------------------------------


@pytest.mark.parametrize("hw", [(360, 640), (500, 300), (224, 224)])
def test_clip_tower_preprocess(hw):
    """Bicubic with antialiasing, clipped to [0, 1], against PIL's. PIL
    resizes in two passes and rounds to uint8 (and clips) after each; on
    random pixels, where bicubic overshoots by tens of steps, that is up to
    0.17 after normalisation (11 steps) with a mean below 0.01; on a smooth
    image it is the rounding alone, half a step per pass: bound one and a
    half steps, 1.5 / 255 / std."""
    rng = np.random.default_rng(50)
    img = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
    ref = jpre.clip_tower_preprocess(Image.fromarray(img), 224)
    out = tpre.clip_tower_preprocess(img, 224)
    assert out.shape == ref.shape == (224, 224, 3)
    diff = np.abs(out.numpy() - ref)
    assert diff.mean() < 0.01 and diff.max() < 0.25
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]]
    smooth = np.stack([yy * 255 // hw[0], xx * 255 // hw[1],
                       (yy + xx) * 255 // sum(hw)], -1).astype(np.uint8)
    ref = jpre.clip_tower_preprocess(Image.fromarray(smooth), 224)
    out = tpre.clip_tower_preprocess(smooth, 224)
    assert np.abs(out.numpy() - ref).max() < 1.5 / 255 / 0.26
    # a batch of frames is the frames one by one
    both = tpre.clip_tower_preprocess(np.stack([img, img[::-1]]), 224)
    assert torch.equal(both[0], tpre.clip_tower_preprocess(img, 224))


@pytest.mark.parametrize("hw,target", [((360, 640), (320, 512)),
                                       ((300, 500), (576, 1024)),
                                       ((640, 360), (320, 512))])
def test_diffusion_preprocess(hw, target):
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]]
    img = np.stack([yy * 255 // hw[0], xx * 255 // hw[1],
                    (yy + xx) * 255 // sum(hw)], -1).astype(np.uint8)
    ref = jpre.diffusion_preprocess(Image.fromarray(img), target)
    out = tpre.diffusion_preprocess(img, target)
    assert out.shape == ref.shape == (*target, 3)
    # bilinear on a smooth image: PIL's uint8 rounding, twice where it
    # scales up again; two steps of 2 / 255
    assert np.abs(out.numpy() - ref).max() < 2 * 2 / 255
    # float input in [0, 1] is the same image
    assert max_abs(tpre.diffusion_preprocess(img / np.float32(255), target),
                   out) < 1e-6
    np.testing.assert_array_equal(
        tpre.clip_resampler_preprocess(img).numpy(),
        jpre.clip_resampler_preprocess(Image.fromarray(img)))


def test_video_frames_match():
    rng = np.random.default_rng(51)
    video = rng.uniform(-1.2, 1.2, (6, 8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(tvio.frames_to_uint8(video),
                                  jvio.frames_to_uint8(video))
    rounds = [rng.integers(0, 256, (16, 4, 4, 3), dtype=np.uint8)
              for _ in range(3)]
    got = tvio.concat_rounds(rounds)
    assert got.shape[0] == 12 + 12 + 16
    np.testing.assert_array_equal(got, jvio.concat_rounds(rounds))


def test_tokenizers_match():
    text = "Turn LEFT at the red door"
    for add_bos in (False, True):
        assert HashFallbackTokenizer().encode(text, add_bos) == \
            JaxTokenizer().encode(text, add_bos)
    assert isinstance(load_tokenizer(), HashFallbackTokenizer)
    # a path that does not load is an error, not a silent stand-in
    with pytest.raises(Exception):
        load_tokenizer("/nonexistent/tokenizer")
    assert LlamaTokenizerAdapter.encode is not None


def test_conversation_templates_match():
    from open_pandora_tpu.pipeline import conversation as jconv
    from open_pandora_tpu_torch.pipeline import conversation as tconv
    assert set(tconv.conv_templates) == set(jconv.conv_templates)
    for name, conv in tconv.conv_templates.items():
        a, b = conv.copy(), jconv.conv_templates[name].copy()
        for c in (a, b):
            c.append_message(c.roles[0], "what happens next?")
            c.append_message(c.roles[1], None)
        assert a.get_prompt() == b.get_prompt(), name


# -- jax-free ---------------------------------------------------------------------

NEW_MODULES = ["models.clip_tower", "models.cluster", "models.llama",
               "models.connector", "models.world_model",
               "ops.dual_cross_attention", "pipeline.conversation",
               "pipeline.preprocess", "pipeline.chat_wm", "utils.video_io"]


def test_debug_run_without_jax():
    """Every module of the slice imports, and a two-round debug session
    (pipeline/cli.py's run on a random image) runs on the CPU, in a process
    where `jax` and `open_pandora_tpu` cannot be imported."""
    imports = "; ".join(f"import open_pandora_tpu_torch.{m}"
                        for m in NEW_MODULES)
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['open_pandora_tpu'] = None; " + imports + "; "
            "import numpy as np; "
            "from open_pandora_tpu_torch.pipeline import cli; "
            "a = cli.build_parser().parse_args(['--image', '', '--action', "
            "'go', '--action', 'turn', '--debug', '--device', 'cpu']); "
            "image = np.random.default_rng(0).integers(0, 256, (40, 48, 3), "
            "dtype=np.uint8); "
            "v = cli.run(cli.build_chat(a), image, a); "
            "print(f'2 rounds -> frames {v.shape} {v.dtype}'); "
            "assert not [m for m in sys.modules if sys.modules[m] is not None"
            " and m.split('.')[0] in ('jax', 'open_pandora_tpu')]")
    done = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                          timeout=300, capture_output=True, text=True)
    assert "2 rounds -> frames (4, 32, 32, 3) uint8" in done.stdout
