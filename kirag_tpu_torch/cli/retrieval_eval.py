"""Retrieval evaluation: P/R/F1@k against qrels, or answer-presence Recall@k
(port of :mod:`kirag_tpu.cli.retrieval_eval`, host code).

Multi-hop datasets with gold qrels get Precision/Recall/F1@k over the ranked
``ctxs`` of a results file (what ``cli/retrieve.py`` writes); datasets
without qrels get has_answer Recall@k. Comparing an exact-search run with an
approximate one (``--search_mode approx``) shows what the approximate search
loses.

Usage:
  python -m kirag_tpu_torch.cli.retrieval_eval --dataset 2wikimultihopqa \\
    --save_file out/kirag/results.json --qrels data/2wiki/qrels.tsv --k 3
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kirag_tpu_torch.evaluation.metrics import has_answer
from kirag_tpu_torch.utils.io import load_json

QRELS_DATASETS = ("hotpotqa", "2wikimultihopqa", "musique")


def setup_parser(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--dataset", type=str, required=True)
    parser.add_argument("--save_file", type=str, required=True)
    parser.add_argument("--qrels", type=str, default=None,
                        help="qrels tsv (qid \\t docno \\t score) for multi-hop datasets")
    parser.add_argument("--k", type=int, default=3)
    return parser.parse_args(argv)


def load_qrels(path: str) -> Dict[str, List[Tuple[str, float]]]:
    results: Dict[str, List[Tuple[str, float]]] = {}
    with open(path, encoding="utf-8") as fin:
        for line in fin:
            qid, docno, score = line.strip().split("\t")
            results.setdefault(qid, []).append((docno, float(score)))
    for item in results.values():
        item.sort(key=lambda x: x[1], reverse=True)
    return results


def evaluate_with_qrels(retrieval_results: List[dict], qrels, k: int) -> Dict[str, float]:
    precision_at_k, recall_at_k, f1_at_k, num_at_k = [], [], [], []
    for example in retrieval_results:
        ctxs = example["ctxs"]
        if len(ctxs) == 0:
            continue
        retrieved = set(ctx["id"] for ctx in ctxs[:k])
        gold = set(docno for docno, score in qrels[example["id"]] if score > 0)
        tp = retrieved & gold
        if not tp:
            precision = recall = f1 = 0.0
        else:
            precision = len(tp) / len(retrieved)
            recall = len(tp) / len(gold) if gold else 0.0
            f1 = 2 * precision * recall / (precision + recall)
        precision_at_k.append(precision)
        recall_at_k.append(recall)
        f1_at_k.append(f1)
        num_at_k.append(len(retrieved))
    return {
        f"Precision@{k}": float(np.mean(precision_at_k)),
        f"Recall@{k}": float(np.mean(recall_at_k)),
        f"F1@{k}": float(np.mean(f1_at_k)),
        f"NumDoc@{k}": float(np.mean(num_at_k)),
    }


def evaluate_answer_presence(retrieval_results: List[dict], k: int) -> Dict[str, float]:
    hits = []
    for example in retrieval_results:
        answers = example["answers"]
        found = 0.0
        for ctx in example["ctxs"][:k]:
            text = ctx.get("text") or " ".join(ctx.get("sentences", []))
            if has_answer(answers, "title: {} text: {}".format(ctx["title"], text)):
                found = 1.0
                break
        hits.append(found)
    return {f"Recall@{k}": float(np.mean(hits))}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Run the CLI on ``argv`` (default: the command line); prints and
    returns the metrics."""
    args = setup_parser(argv)
    results = load_json(args.save_file)
    if args.dataset in QRELS_DATASETS:
        if not args.qrels:
            raise ValueError(f"--qrels is required for {args.dataset}")
        metrics = evaluate_with_qrels(results, load_qrels(args.qrels), args.k)
    else:
        metrics = evaluate_answer_presence(results, args.k)
    print(metrics)
    return metrics


if __name__ == "__main__":
    main()
