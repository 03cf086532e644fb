"""Reader QA evaluation: EM/F1 over retrieved contexts (port of
:mod:`kirag_tpu.cli.qa_eval`).

Feeds each question and its top-k ``ctxs`` to an :class:`AnswerGenerator`
reader over :class:`~kirag_tpu_torch.models.llm.TorchLlamaBackend` and
scores EM / F1 against the gold answers. The reader's weights load in bf16
from ``--reader``; a loaded ``(params, config)`` pair can be handed in
instead, whose 4-bit projections decode through K6 on the GPU.

Usage:
  python -m kirag_tpu_torch.cli.qa_eval --save_file out/kirag/results.json \\
    --reader /ckpts/Meta-Llama-3-8B-Instruct --k 3
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from kirag_tpu_torch.evaluation.metrics import ems, f1_score
from kirag_tpu_torch.utils.io import load_json


def setup_parser(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--save_file", type=str, required=True)
    parser.add_argument("--k", type=int, default=3)
    parser.add_argument("--reader", type=str, required=True,
                        help="LOCAL path to a Llama-architecture chat model")
    parser.add_argument("--batch_size", type=int, default=4)
    return parser.parse_args(argv)


def build_reader(args, llm_tokenizer=None, llm=None, device=None):
    """The AnswerGenerator of ``--reader``. ``llm_tokenizer`` and ``llm`` (a
    loaded ``(params, config)`` pair) replace what the path names; the
    weights load onto ``device`` (default: the GPU)."""
    from kirag_tpu_torch.cli.common import build_llm_tokenizer
    from kirag_tpu_torch.generation.answer import AnswerGenerator
    from kirag_tpu_torch.models.llm import TorchLlamaBackend, load_llama

    tokenizer = llm_tokenizer if llm_tokenizer is not None else build_llm_tokenizer(args.reader)
    if llm is None:
        llm = load_llama(args.reader, compute_dtype=torch.bfloat16, device=device)
    params, config = llm
    backend = TorchLlamaBackend(params, config, eos_token_id=tokenizer.eos_token_id)
    return AnswerGenerator(tokenizer, backend, model_name=args.reader,
                           max_new_tokens=32, batch_size=args.batch_size)


def evaluate(data, reader, k: int, batch_size: int):
    """(EM, F1, predictions) of ``reader`` over the examples' top-``k`` ctxs."""
    questions, contexts, answers_list = [], [], []
    for example in data:
        questions.append(example["question"])
        answers = example["answers"]
        answers_list.append(answers if isinstance(answers, list) else [answers])
        context = []
        for ctx in example["ctxs"][:k]:
            text = ctx.get("text") or " ".join(ctx.get("sentences", []))
            if "title" in ctx:
                context.append("title: {}, text: {}".format(ctx["title"], text))
            else:
                context.append(text)
        contexts.append(context)

    preds = []
    for start in range(0, len(questions), batch_size):
        preds.extend(reader.generate_answer(
            questions[start: start + batch_size],
            context=contexts[start: start + batch_size] if k > 0 else None))

    em_scores = [float(ems(p, gold)) for p, gold in zip(preds, answers_list)]
    f1_scores = [f1_score(p, gold[0])[0] for p, gold in zip(preds, answers_list)]
    return float(np.mean(em_scores)), float(np.mean(f1_scores)), preds


def main(argv: Optional[Sequence[str]] = None, *, llm_tokenizer=None, llm=None,
         device=None) -> Tuple[float, float]:
    """Run the CLI on ``argv`` (default: the command line) and print the
    report. ``llm_tokenizer`` and ``llm`` replace the tokenizer and weights
    that ``--reader`` names; ``device`` is the reader's (default: the GPU).
    Returns (EM, F1)."""
    from kirag_tpu_torch.device import require_cuda

    args = setup_parser(argv)
    device = require_cuda() if device is None else torch.device(device)
    data = load_json(args.save_file)
    reader = build_reader(args, llm_tokenizer, llm, device)
    em, f1, _ = evaluate(data, reader, args.k, args.batch_size)
    print("==================== Evaluation Result ====================")
    print(f">>>> File: {args.save_file}")
    print(f">>>> Topk: {args.k}")
    print(f">>>> Reader: {args.reader}")
    print(f">>>> EM: {em:.5f}")
    print(f">>>> F1: {f1:.5f}")
    print("===========================================================")
    return em, f1


if __name__ == "__main__":
    main()
