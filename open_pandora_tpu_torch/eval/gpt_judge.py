"""LLM-as-judge evaluation: rubrics, resume and scoring (ChatUniVi
benchmark batteries).

The port's own copy of open_pandora_tpu/eval/gpt_judge.py, which is pure
Python (reference ChatUniVi/eval/evaluate/: `evaluate_video_qa.py:42`,
yes/no and a 0-5 score; the five `evaluate_benchmark_{1..5}_*.py`
rubrics, correctness, detail orientation, contextual understanding,
temporal understanding, consistency; `summarize_gpt_review.py`). The
judge is any OpenAI-compatible chat-completions endpoint (`HTTPJudge`,
urllib) or an injected callable. One JSON file per sample, so an
interrupted run resumes as the reference's rescan loop does
(evaluate_video_qa.py:137-161). Its files and scores equal the JAX
module's on the same inputs (tests/test_torch_gpt_judge.py).

Usage:
  python -m open_pandora_tpu_torch.eval.gpt_judge --pred-path preds.jsonl \
      --output-dir DIR --endpoint URL [--rubric video_qa] [--model M]
      [--output-json combined.json] [--num-workers 4]
"""

from __future__ import annotations

import ast
import json
import logging
import os
import re
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

log = logging.getLogger("open_pandora_tpu_torch.eval.gpt_judge")

Message = Dict[str, str]
JudgeFn = Callable[[List[Message]], str]


# ------------------------------------------------------------------ rubrics
@dataclass(frozen=True)
class Rubric:
    name: str
    system: str
    user_template: str
    wants_pred: bool = False      # yes/no verdict in addition to the score
    pairwise: bool = False        # consistency: two questions + two preds

    def messages(self, qa: Dict) -> List[Message]:
        return [{"role": "system", "content": self.system},
                {"role": "user", "content": self.user_template.format(**qa)}]


# NOTE: rubric user_templates are .format()ed once more with the QA fields
# (Rubric.messages), so the literal example dict needs double braces AFTER
# this first format — hence the quadruple braces here.
_TAIL_SCORE = (
    "Please generate the response in the form of a Python dictionary string "
    "with keys 'score', where its value is the {what} score in INTEGER, "
    "not STRING. DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only "
    "provide the Python dictionary string. For example, your response "
    "should look like this: {{{{'score': 4}}}}."
)

_QA_BLOCK = ("Please evaluate the following video-based question-answer "
             "pair:\n\nQuestion: {q}\nCorrect Answer: {a}\n"
             "Predicted Answer: {pred}\n\n")

RUBRICS: Dict[str, Rubric] = {}


def _register(r: Rubric) -> Rubric:
    RUBRICS[r.name] = r
    return r


VIDEO_QA = _register(Rubric(
    name="video_qa",
    system=(
        "You are an intelligent chatbot designed for evaluating the "
        "correctness of generative outputs for question-answer pairs. Your "
        "task is to compare the predicted answer with the correct answer "
        "and determine if they match meaningfully. Here's how you can "
        "accomplish the task:------##INSTRUCTIONS: - Focus on the "
        "meaningful match between the predicted answer and the correct "
        "answer.\n- Consider synonyms or paraphrases as valid matches.\n"
        "- Evaluate the correctness of the prediction compared to the "
        "answer."),
    user_template=(
        _QA_BLOCK +
        "Provide your evaluation only as a yes/no and score where the "
        "score is an integer value between 0 and 5, with 5 indicating the "
        "highest meaningful match. Please generate the response in the "
        "form of a Python dictionary string with keys 'pred' and 'score', "
        "where value of 'pred' is  a string of 'yes' or 'no' and value of "
        "'score' is in INTEGER, not STRING. DO NOT PROVIDE ANY OTHER "
        "OUTPUT TEXT OR EXPLANATION. Only provide the Python dictionary "
        "string. For example, your response should look like this: "
        "{{'pred': 'yes', 'score': 4}}."),
    wants_pred=True,
))

BENCHMARK_1 = _register(Rubric(
    name="correctness",
    system=(
        "You are an intelligent chatbot designed for evaluating the "
        "factual accuracy of generative outputs for video-based "
        "question-answer pairs. Your task is to compare the predicted "
        "answer with the correct answer and determine if they are "
        "factually consistent. Here's how you can accomplish the task:"
        "------##INSTRUCTIONS: - Focus on the factual consistency between "
        "the predicted answer and the correct answer. The predicted answer "
        "should not contain any misinterpretations or misinformation.\n"
        "- The predicted answer must be factually accurate and align with "
        "the video content.\n- Consider synonyms or paraphrases as valid "
        "matches.\n- Evaluate the factual accuracy of the prediction "
        "compared to the answer."),
    user_template=(
        _QA_BLOCK +
        "Provide your evaluation only as a factual accuracy score where "
        "the factual accuracy score is an integer value between 0 and 5, "
        "with 5 indicating the highest level of factual consistency. "
        + _TAIL_SCORE.format(what="factual accuracy")),
))

BENCHMARK_2 = _register(Rubric(
    name="detailed_orientation",
    system=(
        "You are an intelligent chatbot designed for evaluating the detail "
        "orientation of generative outputs for video-based question-answer "
        "pairs. Your task is to compare the predicted answer with the "
        "correct answer and determine its level of detail, considering "
        "both completeness and specificity. Here's how you can accomplish "
        "the task:------##INSTRUCTIONS: - Check if the predicted answer "
        "covers all major points from the video. The response should not "
        "leave out any key aspects.\n- Evaluate whether the predicted "
        "answer includes specific details rather than just generic points. "
        "It should provide comprehensive information that is tied to "
        "specific elements of the video.\n- Consider synonyms or "
        "paraphrases as valid matches.\n- Provide a single evaluation "
        "score that reflects the level of detail orientation of the "
        "prediction, considering both completeness and specificity."),
    user_template=(
        _QA_BLOCK +
        "Provide your evaluation only as a detail orientation score where "
        "the detail orientation score is an integer value between 0 and 5, "
        "with 5 indicating the highest level of detail orientation. "
        + _TAIL_SCORE.format(what="detail orientation")),
))

BENCHMARK_3 = _register(Rubric(
    name="context",
    system=(
        "You are an intelligent chatbot designed for evaluating the "
        "contextual understanding of generative outputs for video-based "
        "question-answer pairs. Your task is to compare the predicted "
        "answer with the correct answer and determine if the generated "
        "response aligns with the overall context of the video content. "
        "Here's how you can accomplish the task:------##INSTRUCTIONS: "
        "- Evaluate whether the predicted answer aligns with the overall "
        "context of the video content. It should not provide information "
        "that is out of context or misaligned.\n- The predicted answer "
        "must capture the main themes and sentiments of the video.\n"
        "- Consider synonyms or paraphrases as valid matches.\n- Provide "
        "your evaluation of the contextual understanding of the prediction "
        "compared to the answer."),
    user_template=(
        _QA_BLOCK +
        "Provide your evaluation only as a contextual understanding score "
        "where the contextual understanding score is an integer value "
        "between 0 and 5, with 5 indicating the highest level of "
        "contextual understanding. "
        + _TAIL_SCORE.format(what="contextual understanding")),
))

BENCHMARK_4 = _register(Rubric(
    name="temporal",
    system=(
        "You are an intelligent chatbot designed for evaluating the "
        "temporal understanding of generative outputs for video-based "
        "question-answer pairs. Your task is to compare the predicted "
        "answer with the correct answer and determine if they correctly "
        "reflect the temporal sequence of events in the video content. "
        "Here's how you can accomplish the task:------##INSTRUCTIONS: "
        "- Focus on the temporal consistency between the predicted answer "
        "and the correct answer. The predicted answer should correctly "
        "reflect the sequence of events or details as they are presented "
        "in the video content.\n- Consider synonyms or paraphrases as "
        "valid matches, but only if the temporal order is maintained.\n"
        "- Evaluate the temporal accuracy of the prediction compared to "
        "the answer."),
    user_template=(
        _QA_BLOCK +
        "Provide your evaluation only as a temporal accuracy score where "
        "the temporal accuracy score is an integer value between 0 and 5, "
        "with 5 indicating the highest level of temporal consistency. "
        + _TAIL_SCORE.format(what="temporal accuracy")),
))

BENCHMARK_5 = _register(Rubric(
    name="consistency",
    system=(
        "You are an intelligent chatbot designed for evaluating the "
        "consistency of generative outputs for similar video-based "
        "question-answer pairs. You will be given two very similar "
        "questions, a common answer common to both the questions and "
        "predicted answers for the two questions .Your task is to compare "
        "the predicted answers for two very similar question, with a "
        "common correct answer and determine if they are consistent. "
        "Here's how you can accomplish the task:------##INSTRUCTIONS: "
        "- Focus on the consistency between the two predicted answers and "
        "the correct answer. Both predicted answers should correspond to "
        "the correct answer and to each other, and should not contain any "
        "contradictions or significant differences in the conveyed "
        "information.\n- Both predicted answers must be consistent with "
        "each other and the correct answer, in terms of the information "
        "they provide about the video content.\n- Consider synonyms or "
        "paraphrases as valid matches, but only if they maintain the "
        "consistency in the conveyed information.\n- Evaluate the "
        "consistency of the two predicted answers compared to the correct "
        "answer."),
    user_template=(
        "Please evaluate the following video-based question-answer pair:"
        "\n\nQuestion 1: {q1}\nQuestion 2: {q2}\nCorrect Answer: {a}\n"
        "Predicted Answer to Question 1: {pred1}\n"
        "Predicted Answer to Question 2: {pred2}\n\n"
        "Provide your evaluation only as a consistency score where the "
        "consistency score is an integer value between 0 and 5, with 5 "
        "indicating the highest level of consistency. "
        + _TAIL_SCORE.format(what="consistency")),
    pairwise=True,
))


# ------------------------------------------------------------------ client
class HTTPJudge:
    """OpenAI-compatible chat-completions endpoint over urllib (the only
    external requirement is the endpoint URL + key; the reference pins
    openai.ChatCompletion/gpt-3.5-turbo, evaluate_video_qa.py:42)."""

    def __init__(self, endpoint: str, api_key: str = "",
                 model: str = "gpt-3.5-turbo", timeout: float = 60.0):
        self.endpoint = endpoint.rstrip("/")
        self.api_key = api_key
        self.model = model
        self.timeout = timeout

    def __call__(self, messages: List[Message]) -> str:
        import urllib.request

        req = urllib.request.Request(
            self.endpoint + "/chat/completions",
            data=json.dumps({"model": self.model,
                             "messages": messages}).encode(),
            headers={"Content-Type": "application/json",
                     **({"Authorization": f"Bearer {self.api_key}"}
                        if self.api_key else {})})
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            body = json.load(resp)
        return body["choices"][0]["message"]["content"]


def parse_judgement(text: str) -> Dict:
    """Parse the judge's dict-string reply; tolerate surrounding prose and
    the reference's quoting glitches ({''score': 4})."""
    m = re.search(r"\{[^{}]*\}", text)
    if not m:
        raise ValueError(f"no dict in judge reply: {text[:200]!r}")
    frag = m.group(0).replace("''", "'")
    out = ast.literal_eval(frag)
    if not isinstance(out, dict) or "score" not in out:
        raise ValueError(f"judge reply missing score: {text[:200]!r}")
    return out


# ----------------------------------------------------------------- runner
def load_predictions(path: str) -> List[Dict]:
    """JSON array or JSONL of prediction records."""
    with open(path, encoding="utf-8") as f:
        head = f.read(1)
        f.seek(0)
        if head == "[":
            return json.load(f)
        return [json.loads(line) for line in f if line.strip()]


def _qa_fields(sample: Dict, rubric: Rubric) -> Dict:
    if rubric.pairwise:
        return {"q1": sample.get("prompt_1", sample.get("Q1", "")),
                "q2": sample.get("prompt_2", sample.get("Q2", "")),
                "a": sample.get("answer", sample.get("A", "")),
                "pred1": sample.get("text_1", sample.get("pred1", "")),
                "pred2": sample.get("text_2", sample.get("pred2", ""))}
    return {"q": sample.get("prompt", sample.get("question", "")),
            "a": sample.get("answer", sample.get("A", "")),
            "pred": sample.get("text", sample.get("pred", ""))}


def annotate(predictions: Sequence[Dict], rubric: Rubric, judge: JudgeFn,
             output_dir: str, num_workers: int = 4,
             max_rounds: int = 3) -> int:
    """Judge every prediction, one JSON per sample under output_dir;
    already-present files are skipped (resume semantics of
    evaluate_video_qa.py:137-161). Returns number judged this call."""
    os.makedirs(output_dir, exist_ok=True)
    keyed = {f"{i}": s for i, s in enumerate(predictions)}

    def work(item) -> bool:
        key, sample = item
        path = os.path.join(output_dir, f"{key}.json")
        qa = _qa_fields(sample, rubric)
        try:
            reply = judge(rubric.messages(qa))
            verdict = parse_judgement(reply)
        except Exception as e:  # noqa: BLE001
            log.warning("judge failed for %s: %s", key, e)
            return False
        with open(path, "w") as f:
            json.dump([verdict, qa], f)
        return True

    n_done = 0
    for _ in range(max_rounds):
        todo = [(k, s) for k, s in keyed.items()
                if not os.path.exists(os.path.join(output_dir, f"{k}.json"))]
        if not todo:
            break
        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            n_done += sum(pool.map(work, todo))
    return n_done


def combine_and_score(output_dir: str,
                      output_json: Optional[str] = None) -> Dict:
    """evaluate_video_qa.py:170-210: merge per-sample files, compute the
    average score and (when present) yes/no accuracy."""
    combined = {}
    for fn in sorted(os.listdir(output_dir)):
        if fn.endswith(".json"):
            with open(os.path.join(output_dir, fn)) as f:
                combined[fn[:-5]] = json.load(f)
    if output_json:
        with open(output_json, "w") as f:
            json.dump(combined, f)
    scores, yes, no = [], 0, 0
    for verdict, _ in combined.values():
        scores.append(float(verdict["score"]))
        pred = str(verdict.get("pred", "")).lower()
        if "yes" in pred:
            yes += 1
        elif "no" in pred:
            no += 1
    n = max(len(scores), 1)
    out = {"n": len(scores),
           "average_score": sum(scores) / n}
    if yes or no:
        out["accuracy"] = yes / max(yes + no, 1)
        out["yes"] = yes
        out["no"] = no
    return out


def summarize_gpt_review(path: str,
                         ignore: Optional[Sequence[int]] = None) -> Dict:
    """summarize_gpt_review.py main: per-category means of review
    'tuple'/'score' records in a JSONL review file; pair records report
    the pred/gpt4 ratio like the reference prints."""
    from collections import defaultdict

    ignore = set(ignore or ())
    scores = defaultdict(list)
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            review = json.loads(line)
            if review.get("question_id") in ignore:
                continue
            val = review.get("tuple", review.get("score"))
            cat = review.get("category", "all")
            scores[cat].append(val)
            if cat != "all":
                scores["all"].append(val)
    out = {}
    for cat, vals in scores.items():
        first = vals[0]
        if isinstance(first, (list, tuple)):
            n = len(first)
            means = [sum(v[i] for v in vals) / len(vals) for i in range(n)]
            out[cat] = {"means": [round(m, 3) for m in means],
                        "ratio_pct": round(means[1] / means[0] * 100, 1)
                        if means[0] else 0.0}
        else:
            out[cat] = {"means": [round(sum(vals) / len(vals), 3)]}
    return out


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser("open-pandora-torch-gpt-judge")
    p.add_argument("--pred-path", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--output-json", default=None)
    p.add_argument("--rubric", default="video_qa", choices=sorted(RUBRICS))
    p.add_argument("--endpoint", required=True,
                   help="OpenAI-compatible base URL, e.g. "
                        "https://api.openai.com/v1")
    p.add_argument("--api-key", default=os.environ.get("OPENAI_API_KEY", ""))
    p.add_argument("--model", default="gpt-3.5-turbo")
    p.add_argument("--num-workers", type=int, default=4)
    args = p.parse_args(argv)

    preds = load_predictions(args.pred_path)
    rubric = RUBRICS[args.rubric]
    judge = HTTPJudge(args.endpoint, args.api_key, args.model)
    n = annotate(preds, rubric, judge, args.output_dir,
                 num_workers=args.num_workers)
    stats = combine_and_score(args.output_dir, args.output_json)
    print(json.dumps({"judged_now": n, **stats}))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
