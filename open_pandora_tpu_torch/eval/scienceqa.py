"""ScienceQA multiple-choice runner and scorer.

Counterpart of open_pandora_tpu/eval/scienceqa.py:
- the runner (reference ChatUniVi/eval/model_vqa_scienceqa.py) decodes
  twice per question: free-form reasoning from the conversation prompt,
  then the prompt with `reasoning + ' ###\\nANSWER:'`, whose first-token
  logits score every candidate letter "(X)" in the question (pred =
  argmax) before the short answer is decoded. Record: {question_id,
  prompt, text, answer_id, model_id, pred, metadata}, text = reasoning +
  '\\n The answer is ' + the short answer;
- the scorer (reference evaluate_science_qa.py): `The answer is ([A-Z]).`
  over the text (else pred), the letter mapped to a choice index (a
  random one when out of range), accuracy overall, by subject, context
  modality and grade band.

Greedy by default; `--temperature` samples from a torch.Generator seeded
by `--seed` (the JAX runner folds its key per call: the same
distribution, not the same draws). `answer_question` is the I/O-free
core (a uint8 image in, a record out); `run` reads the files, the image
through `pipeline.cli.decode_image` (PIL, imported then).

Usage:
  python -m open_pandora_tpu_torch.eval.scienceqa run --questions q.json \\
      --image-folder DIR --out answers.jsonl [--ckpt ...] [--debug]
      [--device cuda] [--quantize-llm [int8|nf4]]
  python -m open_pandora_tpu_torch.eval.scienceqa score --base-dir DIR \\
      --result-file answers.jsonl --output-file out.json \\
      --output-result result.json [--split test]
"""

from __future__ import annotations

import argparse
import json
import os
import random
import re
import sys
from typing import Optional

import numpy as np
import torch

ANSWER_LETTERS = [chr(ord("A") + i) for i in range(26)]


# ------------------------------------------------------------------ runner
def answer_question(wm, tok, line: dict, image: Optional[np.ndarray] = None,
                    *, conv_mode: str = "simple", max_new_tokens: int = 64,
                    temperature: float = 0.0,
                    generator: Optional[torch.Generator] = None) -> dict:
    """One ScienceQA record from `line` (its first conversation turn) and
    its uint8 (H, W, 3) image, if it has one."""
    from open_pandora_tpu_torch.eval.chatunivi_qa import (
        generate_text, segments_from_prompt, strip_stop, tower_images)
    from open_pandora_tpu_torch.models.llama_generate import (
        first_token_logits)
    from open_pandora_tpu_torch.models.world_model import MultimodalPrompt
    from open_pandora_tpu_torch.pipeline.conversation import (SeparatorStyle,
                                                              conv_templates)

    idx = line["id"]
    qs = line["conversations"][0]["value"].replace("<image>", "").strip()
    cur_prompt = qs
    images, n_img = None, 0
    if image is not None:
        images = tower_images(wm, image)
        qs = "<image>\n" + qs
        cur_prompt = "<image>\n" + cur_prompt
        n_img = 1
    conv = conv_templates[conv_mode].copy()
    conv.append_message(conv.roles[0], qs)
    conv.append_message(conv.roles[1], None)
    prompt = conv.get_prompt()
    stop_str = (conv.sep if conv.sep_style != SeparatorStyle.TWO
                else conv.sep2)

    # stage 1: free-form reasoning
    reasoning = strip_stop(generate_text(
        wm, tok, segments_from_prompt(tok, prompt, n_img), images,
        max_new_tokens, temperature, generator), stop_str)

    # stage 2: the letters scored off the first-token logits
    segs2 = segments_from_prompt(tok, prompt + reasoning + " ###\nANSWER:",
                                 n_img)
    with torch.no_grad():
        embeds2, _ = wm.build_inputs_embeds(
            MultimodalPrompt(segments=segs2, images=images))
        scores = first_token_logits(wm.llama, embeds2)[0].float().cpu()
    candidates = [c for c in ANSWER_LETTERS if "(" + c + ")" in cur_prompt]
    if not candidates:
        candidates = ["A"]
    label_score = [float(scores[tok.encode(c)[-1]]) for c in candidates]
    pred = candidates[int(np.argmax(label_score))]
    short = strip_stop(generate_text(
        wm, tok, segs2, images, min(64, max_new_tokens), temperature,
        generator), stop_str)
    return {"question_id": idx, "prompt": cur_prompt,
            "text": reasoning + "\n The answer is " + short,
            "answer_id": f"sqa-{idx}", "model_id": "open-pandora-tpu",
            "pred": pred, "metadata": {}}


def run(args) -> int:
    from open_pandora_tpu_torch.eval.chatunivi_qa import (get_chunk,
                                                          setup_model)
    from open_pandora_tpu_torch.pipeline.cli import decode_image

    wm, tok, _, _ = setup_model(args.ckpt, args.tokenizer, args.debug,
                                args.device, args.quantize_llm)
    max_new = 4 if args.debug else args.max_new_tokens
    with open(os.path.expanduser(args.questions)) as f:
        questions = json.load(f)
    questions = get_chunk(questions, args.num_chunks, args.chunk_idx)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    generator = torch.Generator(device=wm.device).manual_seed(args.seed)
    with open(os.path.expanduser(args.out), "w") as fout:
        for line in questions:
            image = None
            if "image" in line:
                image = decode_image(os.path.join(
                    args.image_folder, line["image"].replace("\\", "/")))
            rec = answer_question(wm, tok, line, image,
                                  conv_mode=args.conv_mode,
                                  max_new_tokens=max_new,
                                  temperature=args.temperature,
                                  generator=generator)
            fout.write(json.dumps(rec) + "\n")
            fout.flush()
    print(f"[scienceqa] wrote {len(questions)} answers -> {args.out}",
          flush=True)
    return 0


# ------------------------------------------------------------------ scorer
def get_pred_idx(prediction: str, choices, options):
    """evaluate_science_qa.py: letter -> choice index; a random in-range
    index when the parsed letter is not a choice."""
    if prediction in options[: len(choices)]:
        return options.index(prediction)
    return random.choice(range(len(choices)))


def score_predictions(problems, split_indices, predictions,
                      options=("A", "B", "C", "D", "E")):
    """evaluate_science_qa.py's main loop. Returns (results, sqa_results)."""
    options = list(options)
    results = {"correct": [], "incorrect": []}
    sqa = {"acc": None, "correct": None, "count": None, "results": {},
           "outputs": {}, "NAT": [], "SOC": [], "LAN": [], "TXT": [],
           "IMG": [], "NO": [], "G1-6": [], "G7-12": []}
    pattern = re.compile(r"The answer is ([A-Z]).")

    for prob_id in split_indices:
        prob = problems[prob_id]
        if prob_id not in predictions:
            continue
        pred = predictions[prob_id]
        res = pattern.findall(pred["text"])
        answer = res[0] if len(res) == 1 else pred["pred"]
        pred_idx = get_pred_idx(answer, prob["choices"], options)

        analysis = {"question_id": prob_id, "parsed_ans": answer,
                    "ground_truth": options[prob["answer"]],
                    "question": pred["prompt"], "pred": pred["text"],
                    "is_multimodal": "<image>" in pred["prompt"]}
        sqa["results"][prob_id] = get_pred_idx(answer, prob["choices"],
                                               options)
        sqa["outputs"][prob_id] = pred["text"]

        cur = 1 if pred_idx == prob["answer"] else 0
        results["correct" if cur else "incorrect"].append(analysis)
        subject = {"natural science": "NAT", "social science": "SOC",
                   "language science": "LAN"}.get(prob.get("subject"))
        if subject:
            sqa[subject].append(cur)
        if prob.get("hint"):
            sqa["TXT"].append(cur)
        if prob.get("image"):
            sqa["IMG"].append(cur)
        if not prob.get("hint") and not prob.get("image"):
            sqa["NO"].append(cur)
        grade = prob.get("grade", "")
        if grade in [f"grade{g}" for g in range(1, 7)]:
            sqa["G1-6"].append(cur)
        elif grade in [f"grade{g}" for g in range(7, 13)]:
            sqa["G7-12"].append(cur)

    correct = len(results["correct"])
    total = correct + len(results["incorrect"])
    sqa["acc"] = correct / total * 100 if total else 0.0
    sqa["correct"] = correct
    sqa["count"] = total
    return results, sqa


def score(args) -> int:
    base = args.base_dir
    with open(os.path.join(base, "pid_splits.json")) as f:
        split_indices = json.load(f)[args.split]
    with open(os.path.join(base, "problems.json")) as f:
        problems = json.load(f)
    predictions = {}
    with open(args.result_file) as f:
        for line in f:
            if line.strip():
                rec = json.loads(line)
                predictions[rec["question_id"]] = rec

    results, sqa = score_predictions(problems, split_indices, predictions,
                                     args.options)
    print(f"Total: {sqa['count']}, Correct: {sqa['correct']}, "
          f"Accuracy: {sqa['acc']:.2f}%")
    for k in ("NAT", "SOC", "LAN", "TXT", "IMG", "NO", "G1-6", "G7-12"):
        n = len(sqa[k])
        acc = (sum(sqa[k]) / n * 100) if n else 0.0
        print(f"{k}: {n}, Correct: {sum(sqa[k])}, Accuracy: {acc:.2f}%")
    if args.output_file:
        with open(args.output_file, "w") as f:
            json.dump(results, f, indent=2)
    if args.output_result:
        with open(args.output_result, "w") as f:
            json.dump(sqa, f, indent=2)
    return 0


def build_parser():
    from open_pandora_tpu_torch.eval.chatunivi_qa import add_model_args

    p = argparse.ArgumentParser("scienceqa")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run")
    r.add_argument("--questions", required=True)
    r.add_argument("--image-folder", default="")
    r.add_argument("--out", required=True)
    r.add_argument("--ckpt", default=None)
    r.add_argument("--tokenizer", default=None)
    r.add_argument("--conv-mode", default="simple")
    r.add_argument("--num-chunks", type=int, default=1)
    r.add_argument("--chunk-idx", type=int, default=0)
    r.add_argument("--max-new-tokens", type=int, default=64)
    r.add_argument("--temperature", type=float, default=0.0)
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--debug", action="store_true")
    add_model_args(r)
    r.set_defaults(fn=run)

    s = sub.add_parser("score")
    s.add_argument("--base-dir", required=True)
    s.add_argument("--result-file", required=True)
    s.add_argument("--output-file", default=None)
    s.add_argument("--output-result", default=None)
    s.add_argument("--split", default="test")
    s.add_argument("--options", nargs="+",
                   default=["A", "B", "C", "D", "E"])
    s.set_defaults(fn=score)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
