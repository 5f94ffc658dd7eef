"""PyTorch port, the ChatUniVi answer runners (eval/chatunivi_qa.py,
eval/scienceqa.py, eval/consistency.py) against the JAX package's (tiny
WorldModel, fp32, CPU): the host helpers on the same inputs; each runner's
`main` on the same question files, image and video, with the same
weights (test_torch_world_slice.make_world) and the same tower images,
writing JAX's records token for token; each `main --debug --device cpu`
on its own; the parsers."""

import json
import random

import numpy as np
import pytest
import torch
from PIL import Image

from open_pandora_tpu.eval import chatunivi_qa as jqa
from open_pandora_tpu.eval import consistency as jcons
from open_pandora_tpu.eval import scienceqa as jsqa
from open_pandora_tpu.pipeline import preprocess as jpre
from open_pandora_tpu.pipeline.tokenizers import load_tokenizer as jtok
from open_pandora_tpu_torch.eval import chatunivi_qa as tqa
from open_pandora_tpu_torch.eval import consistency as tcons
from open_pandora_tpu_torch.eval import scienceqa as tsqa
from open_pandora_tpu_torch.models import world_model as twm
from open_pandora_tpu_torch.pipeline.preprocess import clip_tower_preprocess
from open_pandora_tpu_torch.pipeline.tokenizers import load_tokenizer
from open_pandora_tpu_torch.utils.video_io import write_video
from test_torch_world_slice import make_world

MAX_NEW = 5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- host helpers ---------------------------------------------------------------


def _segs(segs):
    """Segments of either package as comparable tuples."""
    out = []
    for s in segs:
        name = type(s).__name__
        if name == "TokenSegment":
            out.append((name, [int(i) for i in np.asarray(s.ids).ravel()]))
        elif name == "ImageSegment":
            out.append((name, s.index))
        else:
            out.append((name, tuple(s.indices)))
    return out


@pytest.mark.parametrize("prompt,n", [
    ("A chat. ###Human: what is this ###Assistant:", 0),
    ("A chat. ###Human: <image>\nwhat is this ###Assistant:", 1),
    ("sys USER: <image><image><image><image>\nwhy? ASSISTANT:", 4),
    ("<image>\nfirst <image> then <image><image> end", 4),
    ("trailing <image>", 1),
])
def test_segments_from_prompt_as_jax(prompt, n):
    ref = jqa.segments_from_prompt(jtok(None), prompt, n)
    got = tqa.segments_from_prompt(load_tokenizer(None), prompt, n)
    assert _segs(got) == _segs(ref)
    assert all(s.ids.dtype == torch.int64 for s in got
               if isinstance(s, twm.TokenSegment))
    with pytest.raises(ValueError, match="media slots"):
        tqa.segments_from_prompt(load_tokenizer(None), prompt, n + 1)


@pytest.mark.parametrize("text,stop", [
    ("  the answer ###", "###"), ("a ### b ###", "###"), ("plain", "###"),
    ("ends with </s>", "</s>"), (" x ", ""), ("###", "###")])
def test_strip_stop_as_jax(text, stop):
    assert tqa.strip_stop(text, stop) == jqa.strip_stop(text, stop)


@pytest.mark.parametrize("n,chunks", [(10, 3), (7, 7), (5, 8), (0, 2)])
def test_get_chunk_as_jax(n, chunks):
    items = list(range(n))
    got = [tqa.get_chunk(items, chunks, i) for i in range(chunks)]
    assert got == [jqa.get_chunk(items, chunks, i) for i in range(chunks)]
    assert sum(got, []) == items


def test_get_pred_idx_and_scoring_as_jax():
    opts = ["A", "B", "C", "D", "E"]
    for pred, choices in [("B", ["x", "y"]), ("E", ["x", "y", "z"]),
                          ("Z", ["x", "y", "z", "w"]), ("A", ["x"])]:
        random.seed(3)
        ref = jsqa.get_pred_idx(pred, choices, opts)
        random.seed(3)
        assert tsqa.get_pred_idx(pred, choices, opts) == ref
    rng = np.random.default_rng(5)
    subjects = ["natural science", "social science", "language science"]
    problems, preds = {}, {}
    for i in range(14):
        pid = f"p{i}"
        problems[pid] = {"choices": ["a", "b", "c"][: 2 + i % 2],
                         "answer": int(rng.integers(0, 2)),
                         "subject": subjects[i % 3],
                         "hint": "h" if i % 4 == 0 else "",
                         "image": "i.png" if i % 3 == 0 else None,
                         "grade": f"grade{1 + i}"}
        text = (f"The answer is {'ABCZ'[i % 4]}." if i % 5 else "no letter")
        if i < 12:      # two problems without a prediction
            preds[pid] = {"text": text, "pred": "AB"[i % 2],
                          "prompt": "<image>\nq" if i % 2 else "q"}
    split = [f"p{i}" for i in range(14)]
    random.seed(4)
    ref = jsqa.score_predictions(problems, split, preds)
    random.seed(4)
    assert tsqa.score_predictions(problems, split, preds) == ref
    assert ref[1]["count"] == 12


@pytest.mark.parametrize("runner", ["chatunivi_qa", "scienceqa",
                                    "consistency"])
def test_parser_matches_jax(runner):
    """The JAX parser's options and defaults; the port adds --device and
    --quantize-llm."""
    argv = {"chatunivi_qa": ["--questions", "q.jsonl", "--out", "o"],
            "scienceqa": ["run", "--questions", "q.json", "--out", "o"],
            "consistency": ["--questions", "q.json", "--out", "o"]}[runner]
    port = {"chatunivi_qa": tqa, "scienceqa": tsqa,
            "consistency": tcons}[runner]
    jax_mod = {"chatunivi_qa": jqa, "scienceqa": jsqa,
               "consistency": jcons}[runner]
    ours = vars(port.build_parser().parse_args(argv))
    assert ours.pop("device") == "cuda" and ours.pop("quantize_llm") is False
    ref = vars(jax_mod.build_parser().parse_args(argv))
    ours.pop("fn", None), ref.pop("fn", None)
    assert ours == ref
    assert vars(port.build_parser().parse_args(
        argv + ["--quantize-llm"]))["quantize_llm"] == "int8"


# -- the runners against JAX's, same weights --------------------------------------


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    d = tmp_path_factory.mktemp("media")
    rng = np.random.default_rng(37)
    Image.fromarray(rng.integers(0, 256, (40, 60, 3), np.uint8)).save(
        d / "a.png")
    write_video(str(d / "v.mp4"), rng.integers(0, 256, (8, 48, 64, 3),
                                               np.uint8))
    return d


@pytest.fixture(scope="module")
def world():
    return make_world(seed=36)


@pytest.fixture
def same_model(world, monkeypatch):
    """Both packages' setup_model hand back the same weights; the JAX
    runners preprocess tower images as the port does (the two resizes
    differ by about one uint8 step, which can move a token)."""
    cfg, jmodel, params, port = world
    monkeypatch.setattr(jqa, "setup_model",
                        lambda *a, **k: (jmodel, params, jtok(None), 32, 32))
    monkeypatch.setattr(tqa, "setup_model",
                        lambda *a, **k: (port, load_tokenizer(None), 32, 32))
    monkeypatch.setattr(jpre, "clip_tower_preprocess", lambda img, size: (
        clip_tower_preprocess(np.asarray(img.convert("RGB")), size).numpy()))


def _lines(path):
    return [json.loads(ln) for ln in open(path) if ln.strip()]


def test_chatunivi_qa_matches_jax(same_model, media, tmp_path):
    q = tmp_path / "q.jsonl"
    q.write_text("\n".join(json.dumps(r) for r in [
        {"id": 1, "text": "what is in the image", "image": "a.png"},
        {"question_id": 2, "question": "what happens", "video": "v.mp4"},
        {"id": 3, "text": "say something"}]) + "\n")
    common = ["--questions", str(q), "--media-dir", str(media),
              "--max-new-tokens", str(MAX_NEW), "--video-frames", "4"]
    assert jqa.main(common + ["--out", str(tmp_path / "j.jsonl")]) == 0
    assert tqa.main(common + ["--out", str(tmp_path / "t.jsonl"),
                              "--device", "cpu"]) == 0
    ref, got = _lines(tmp_path / "j.jsonl"), _lines(tmp_path / "t.jsonl")
    assert got == ref and len(got) == 3
    assert [r["id"] for r in got] == [1, 2, 3]
    assert all(len(r["answer"].split()) == MAX_NEW for r in got)


def test_scienceqa_matches_jax(same_model, media, tmp_path):
    q = tmp_path / "q.json"
    q.write_text(json.dumps([
        {"id": "s1", "image": "a.png", "conversations": [
            {"value": "<image>\nWhich animal? (A) cat (B) dog (C) fish"}]},
        {"id": "s2", "conversations": [{"value": "Pick one (A) x (B) y"}]}]))
    common = ["run", "--questions", str(q), "--image-folder", str(media),
              "--max-new-tokens", str(MAX_NEW)]
    assert jsqa.main(common + ["--out", str(tmp_path / "j.jsonl")]) == 0
    assert tsqa.main(common + ["--out", str(tmp_path / "t.jsonl"),
                               "--device", "cpu"]) == 0
    ref, got = _lines(tmp_path / "j.jsonl"), _lines(tmp_path / "t.jsonl")
    assert got == ref and len(got) == 2
    assert set(got[0]) == {"question_id", "prompt", "text", "answer_id",
                           "model_id", "pred", "metadata"}
    assert got[0]["pred"] in "ABC" and got[1]["pred"] in "AB"


def test_consistency_matches_jax(same_model, media, tmp_path):
    q = tmp_path / "q.json"
    q.write_text(json.dumps([
        {"video_name": "v", "Q1": "what moves?", "Q2": "what is moving?",
         "A": "a car"},
        {"video_name": "absent", "Q1": "a", "Q2": "b", "A": "c"}]))
    common = ["--questions", str(q), "--video-folder", str(media),
              "--max-new-tokens", str(MAX_NEW), "--max-frames", "4"]
    assert jcons.main(common + ["--out", str(tmp_path / "j.jsonl")]) == 0
    assert tcons.main(common + ["--out", str(tmp_path / "t.jsonl"),
                                "--device", "cpu"]) == 0
    ref, got = _lines(tmp_path / "j.jsonl"), _lines(tmp_path / "t.jsonl")
    assert got == ref and len(got) == 1
    assert got[0]["answer_id"] == "vc-0" and got[0]["text_1"]


# -- --debug on the port's own tiny config ------------------------------------------


@pytest.mark.parametrize("runner", ["chatunivi_qa", "scienceqa",
                                    "consistency"])
def test_debug_main_writes_records(runner, media, tmp_path):
    out = tmp_path / "o.jsonl"
    if runner == "chatunivi_qa":
        q = tmp_path / "q.jsonl"
        q.write_text(json.dumps({"id": 7, "text": "hi", "image": "a.png"})
                     + "\n")
        argv = ["--questions", str(q), "--media-dir", str(media)]
        rc = tqa.main(argv + ["--out", str(out), "--debug", "--device", "cpu"])
        keys = {"id", "question", "answer"}
    elif runner == "scienceqa":
        q = tmp_path / "q.json"
        q.write_text(json.dumps([{"id": "s", "conversations": [
            {"value": "(A) up (B) down"}]}]))
        rc = tsqa.main(["run", "--questions", str(q), "--out", str(out),
                        "--debug", "--device", "cpu", "--quantize-llm"])
        keys = {"question_id", "prompt", "text", "answer_id", "model_id",
                "pred", "metadata"}
    else:
        q = tmp_path / "q.json"
        q.write_text(json.dumps([{"video_name": "v", "Q1": "a", "Q2": "b",
                                  "A": "c"}]))
        rc = tcons.main(["--questions", str(q), "--video-folder", str(media),
                         "--out", str(out), "--debug", "--device", "cpu",
                         "--max-frames", "4", "--temperature", "0.7"])
        keys = {"video_name", "prompt_1", "text_1", "prompt_2", "text_2",
                "answer_id", "model_id", "answer", "metadata"}
    assert rc == 0
    recs = _lines(out)
    assert len(recs) == 1 and set(recs[0]) == keys
    texts = [v for k, v in recs[0].items() if k in ("answer", "text_1",
                                                    "text_2")]
    # --debug decodes at most 4 tokens a question
    assert all(1 <= len(t.split()) <= 4 for t in texts)
