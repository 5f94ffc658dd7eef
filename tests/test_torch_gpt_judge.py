"""PyTorch port, eval/gpt_judge.py against the JAX package's module (pure
Python on both sides): every rubric's messages, parse_judgement on the
reference's glitch strings, load_predictions, annotate -> combine_and_score
-> summarize_gpt_review with a fixed fake judge (the files byte for byte
and the scores), and main against an OpenAI-compatible endpoint on
localhost (the request bodies and the printed line)."""

import http.server
import json
import os
import threading

import pytest

from open_pandora_tpu.eval import gpt_judge as jj
from open_pandora_tpu_torch.eval import gpt_judge as tj

QA = {"q": "what animal {is} it", "a": "a cat", "pred": "a red cat",
      "q1": "what moves", "q2": "what is moving", "pred1": "a car",
      "pred2": "a truck"}

PREDS = [
    {"prompt": "what animal", "answer": "a cat", "text": "a cat"},
    {"question": "what animal", "A": "a cat", "pred": "a dog"},
    {"prompt": "what color", "answer": "red", "text": "a red cat"},
    {"prompt_1": "q one", "prompt_2": "q two", "answer": "cat",
     "text_1": "cat", "text_2": "dog"},
    {"Q1": "x", "Q2": "y", "A": "z", "pred1": "z", "pred2": "w"},
]


def fake_judge(messages):
    """A fixed reply per prompt: yes and 5 where the first predicted answer
    line names a cat; the reference's quoting glitch on every third."""
    user = messages[1]["content"]
    line = next(ln for ln in user.split("\n")
                if ln.startswith("Predicted Answer"))
    ok = "cat" in line
    if len(user) % 3 == 0:
        return "{''score': %d}" % (4 if ok else 2)
    return "Sure: {'pred': '%s', 'score': %d} done" % (
        "yes" if ok else "no", 5 if ok else 1)


def test_rubrics_equal_jax():
    assert list(tj.RUBRICS) == list(jj.RUBRICS)
    for name, r in tj.RUBRICS.items():
        ref = jj.RUBRICS[name]
        assert (r.name, r.system, r.user_template, r.wants_pred,
                r.pairwise) == (ref.name, ref.system, ref.user_template,
                                ref.wants_pred, ref.pairwise)
        assert r.messages(QA) == ref.messages(QA)


@pytest.mark.parametrize("text", [
    "{''score': 4}", "Sure: {'pred': 'yes', 'score': 5} done",
    "{'pred': 'no', 'score': 0}\n{'score': 3}", "no dict here",
    "{'pred': 'yes'}", "[1, 2]"])
def test_parse_judgement_equals_jax(text):
    try:
        ref = jj.parse_judgement(text)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tj.parse_judgement(text)
        assert str(got.value) == str(e)
        return
    assert tj.parse_judgement(text) == ref


def test_load_predictions_and_fields(tmp_path):
    (tmp_path / "p.json").write_text(json.dumps(PREDS))
    (tmp_path / "p.jsonl").write_text(
        "\n".join(json.dumps(p) for p in PREDS) + "\n\n")
    for f in ("p.json", "p.jsonl"):
        path = str(tmp_path / f)
        assert tj.load_predictions(path) == jj.load_predictions(path) == PREDS
    for sample in PREDS:
        for name in tj.RUBRICS:
            assert tj._qa_fields(sample, tj.RUBRICS[name]) == \
                jj._qa_fields(sample, jj.RUBRICS[name])


def _tree(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("rubric", sorted(jj.RUBRICS))
def test_annotate_combine_equal_jax(rubric, tmp_path):
    out = {}
    for tag, mod in (("jax", jj), ("port", tj)):
        d = str(tmp_path / tag)
        n = mod.annotate(PREDS, mod.RUBRICS[rubric], fake_judge, d,
                         num_workers=2)
        again = mod.annotate(PREDS, mod.RUBRICS[rubric], fake_judge, d)
        combined = str(tmp_path / f"{tag}.json")
        stats = mod.combine_and_score(d, combined)
        out[tag] = (n, again, stats, _tree(d),
                    open(combined, "rb").read())
    assert out["port"] == out["jax"]
    assert out["port"][0] == len(PREDS) and out["port"][1] == 0


def test_annotate_resumes_after_a_failing_judge(tmp_path):
    """A judge that fails on one sample leaves no file for it; the next
    call judges only that one, in both packages."""
    def flaky(messages):
        if "a dog" in messages[1]["content"]:
            raise RuntimeError("endpoint down")
        return fake_judge(messages)

    for mod in (jj, tj):
        d = str(tmp_path / mod.__name__)
        assert mod.annotate(PREDS[:3], mod.RUBRICS["video_qa"], flaky, d,
                            max_rounds=2) == 2
        assert mod.annotate(PREDS[:3], mod.RUBRICS["video_qa"], fake_judge,
                            d) == 1
    assert _tree(str(tmp_path / tj.__name__)) == \
        _tree(str(tmp_path / jj.__name__))


def test_summarize_gpt_review_equals_jax(tmp_path):
    pairs = [{"question_id": 1, "category": "conv", "tuple": [8, 6]},
             {"question_id": 2, "category": "conv", "tuple": [7, 7]},
             {"question_id": 3, "category": "detail", "tuple": [9, 3]},
             {"question_id": 4, "tuple": [5, 5]},
             {"question_id": 6, "category": "detail", "tuple": [0, 5]}]
    scores = [{"question_id": 1, "category": "complex", "score": 4},
              {"question_id": 2, "score": 2},
              {"question_id": 3, "category": "complex", "score": 1}]
    for i, rows in enumerate((pairs, scores)):
        path = tmp_path / f"review{i}.jsonl"
        path.write_text("\n".join(json.dumps(r) for r in rows) + "\n\n")
        for ignore in (None, [2, 6]):
            assert tj.summarize_gpt_review(str(path), ignore) == \
                jj.summarize_gpt_review(str(path), ignore)


class _Endpoint(http.server.BaseHTTPRequestHandler):
    bodies = []

    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        self.bodies.append((self.path, self.headers.get("Authorization"),
                            body))
        reply = json.dumps({"choices": [{"message": {
            "content": fake_judge(body["messages"])}}]}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(reply)))
        self.end_headers()
        self.wfile.write(reply)

    def log_message(self, *a):
        pass


def test_main_against_a_local_endpoint(tmp_path, capsys):
    """Both mains judge the same predictions through HTTPJudge: the same
    requests, files and printed line."""
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Endpoint)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    pred = tmp_path / "preds.jsonl"
    pred.write_text("\n".join(json.dumps(p) for p in PREDS[:3]))
    url = f"http://127.0.0.1:{srv.server_address[1]}/v1/"
    got = {}
    try:
        for tag, mod in (("jax", jj), ("port", tj)):
            _Endpoint.bodies = []
            capsys.readouterr()
            assert mod.main(["--pred-path", str(pred), "--output-dir",
                             str(tmp_path / tag), "--endpoint", url,
                             "--api-key", "k", "--model", "m",
                             "--num-workers", "1", "--output-json",
                             str(tmp_path / f"{tag}.json")]) == 0
            got[tag] = (capsys.readouterr().out,
                        sorted(_Endpoint.bodies, key=json.dumps),
                        _tree(str(tmp_path / tag)))
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    assert got["port"] == got["jax"]
    assert got["port"][1][0][:2] == ("/v1/chat/completions", "Bearer k")
    assert json.loads(got["port"][0])["judged_now"] == 3
