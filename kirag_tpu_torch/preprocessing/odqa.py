"""Open-domain QA preprocessing: corpora, qrels and splits for multi-hop data
(port of :mod:`kirag_tpu.preprocessing.odqa`, host code only).

The counterpart of the reference `preprocessing/construct_odqa_for_multihop_qa.py`:
per dataset it (1) deduplicates context documents by content hash into
``corpus.json`` (records of ``{"id", "title", "sentences"}``), (2) builds
qrels (``qid \\t docid \\t 1``) from supporting facts, (3) splits the original
train set into train/dev (--num_dev_data, seed 0) keeping the original dev as
test, (4) writes ``is_comparison_map.pkl`` for hotpotqa/2wiki.

Raw-data layouts supported (same files the reference consumes):
- 2wikimultihopqa: train/dev/test.json with ``context`` [[title, sentences]]
  and ``supporting_facts`` [[title, sent_idx]];
- musique: musique_ans_v1.0_{split}.jsonl with ``paragraphs`` and
  ``question_decomposition``;
- hotpotqa: hotpot_{train_v1.1, dev_distractor_v1}.json + the bz2 abstracts
  dump for the corpus;
- webqa / bamboogle: question/answer TSVs (test-only conversion).
"""

from __future__ import annotations

import argparse
import logging
import os
import pickle
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kirag_tpu_torch.kg.triples import sent_tokenize
from kirag_tpu_torch.utils.io import hash_object, load_json, load_tsv, save_json, save_tsv

logger = logging.getLogger(__name__)


def build_corpus_from_contexts(context_iter) -> Tuple[Dict[str, str], List[dict]]:
    """Dedup (title, sentences) docs by content hash; assign sequential ids.

    ``context_iter`` yields (title, sentences) pairs.
    """
    corpus: "OrderedDict[str, dict]" = OrderedDict()
    for title, sentences in context_iter:
        doc_obj = {"title": title, "sentences": list(sentences)}
        doc_hash = hash_object(doc_obj)
        if doc_hash not in corpus:
            corpus[doc_hash] = doc_obj
    hash_to_id: Dict[str, str] = {}
    records: List[dict] = []
    for i, (doc_hash, doc_obj) in enumerate(corpus.items()):
        hash_to_id[doc_hash] = str(i)
        records.append({"id": str(i), **doc_obj})
    return hash_to_id, records


def _doc_hash(title: str, sentences: List[str]) -> str:
    return hash_object({"title": title, "sentences": list(sentences)})


def _split(orig_train: List[dict], orig_dev: List[dict], num_dev: int):
    """Random train/dev split of the original train set (seed 0); original dev
    becomes the test set (reference :118-123)."""
    if num_dev >= len(orig_train):
        raise ValueError(
            f"num_dev_data={num_dev} >= train set size {len(orig_train)}")
    rng = np.random.RandomState(0)
    indices = rng.permutation(len(orig_train))
    split = len(orig_train) - num_dev  # num_dev == 0 keeps the full train set
    train = [orig_train[i] for i in indices[:split]]
    dev = [orig_train[i] for i in indices[split:]]
    return train, dev, orig_dev


# -- 2WikiMultiHopQA -----------------------------------------------------------

def process_2wikimultihopqa(raw_dir: str, num_dev: int = 500):
    files = ["train.json", "dev.json", "test.json"]

    def contexts():
        for f in files:
            path = os.path.join(raw_dir, f)
            if not os.path.exists(path):
                continue
            for example in load_json(path):
                for title, sentences in example["context"]:
                    yield title, sentences

    hash_to_id, corpus = build_corpus_from_contexts(contexts())

    qrels, orig_train, orig_dev = [], [], []
    for f in ["train.json", "dev.json"]:
        qa_pairs = orig_train if "train" in f else orig_dev
        for example in load_json(os.path.join(raw_dir, f)):
            qid = example["_id"]
            seen, supporting_facts = set(), []
            for sf_title, sf_sent_idx in example["supporting_facts"]:
                doc_id = None
                for title, sentences in example["context"]:
                    if sf_title.strip().lower() == title.strip().lower():
                        doc_id = hash_to_id[_doc_hash(title, sentences)]
                        break
                assert doc_id is not None, f"supporting fact {sf_title} not in context"
                supporting_facts.append((doc_id, sf_sent_idx))
                if (qid, doc_id) not in seen:
                    seen.add((qid, doc_id))
                    qrels.append((qid, doc_id, 1))
            qa_pairs.append({"id": qid, "question": example["question"],
                             "answers": [example["answer"]],
                             "supporting_facts": supporting_facts})
    train, dev, test = _split(orig_train, orig_dev, num_dev)
    return corpus, qrels, train, dev, test


# -- MuSiQue ----------------------------------------------------------------------

def process_musique(raw_dir: str, num_dev: int = 500):
    files = ["musique_ans_v1.0_train.jsonl", "musique_ans_v1.0_dev.jsonl",
             "musique_ans_v1.0_test.jsonl"]

    def contexts():
        for f in files:
            path = os.path.join(raw_dir, f)
            if not os.path.exists(path):
                continue
            for example in load_json(path, type="jsonl"):
                for para in example["paragraphs"]:
                    yield para["title"], sent_tokenize(para["paragraph_text"])

    hash_to_id, corpus = build_corpus_from_contexts(contexts())

    qrels, orig_train, orig_dev = [], [], []
    for f in files[:2]:
        qa_pairs = orig_train if "train" in f else orig_dev
        for example in load_json(os.path.join(raw_dir, f), type="jsonl"):
            qid = example["id"]
            seen, supporting_facts = set(), []
            for step in example["question_decomposition"]:
                para = example["paragraphs"][step["paragraph_support_idx"]]
                sentences = sent_tokenize(para["paragraph_text"])
                doc_id = hash_to_id[_doc_hash(para["title"], sentences)]
                if (qid, doc_id) not in seen:
                    seen.add((qid, doc_id))
                    qrels.append((qid, doc_id, 1))
                sf_sent_idx = 0
                for i, sentence in enumerate(sentences):
                    if step["answer"].lower() in sentence.lower():
                        sf_sent_idx = i
                        break
                supporting_facts.append((doc_id, sf_sent_idx))
            qa_pairs.append({"id": qid, "question": example["question"],
                             "answers": [example["answer"]],
                             "supporting_facts": supporting_facts})
    train, dev, test = _split(orig_train, orig_dev, num_dev)
    return corpus, qrels, train, dev, test


# -- HotPotQA -----------------------------------------------------------------------

def process_hotpotqa(raw_dir: str, num_dev: int = 500,
                     corpus_folder: str = "enwiki-20171001-pages-meta-current-withlinks-abstracts"):
    import bz2
    import glob
    import json

    corpus_records: List[dict] = []
    title_to_doc: Dict[str, dict] = {}
    pattern = os.path.join(raw_dir, corpus_folder, "*", "wiki_*.bz2")
    for filepath in sorted(glob.glob(pattern)):
        with bz2.BZ2File(filepath) as fin:
            for datum in fin.readlines():
                instance = json.loads(datum.strip())
                rec = {"id": instance["id"], "title": instance["title"],
                       "sentences": instance["text"]}
                corpus_records.append(rec)
                title_to_doc[rec["title"]] = rec
    corpus_records.sort(key=lambda x: int(x["id"]))

    qrels, orig_train, orig_dev = [], [], []
    for f in ["hotpot_train_v1.1.json", "hotpot_dev_distractor_v1.json"]:
        qa_pairs = orig_train if "train" in f else orig_dev
        for example in load_json(os.path.join(raw_dir, f)):
            qid = example["_id"]
            seen, supporting_facts = set(), []
            for sf_title, sf_sent_idx in example["supporting_facts"]:
                doc_id = title_to_doc[sf_title]["id"]
                supporting_facts.append((doc_id, sf_sent_idx))
                if (qid, doc_id) not in seen:
                    seen.add((qid, doc_id))
                    qrels.append((qid, doc_id, 1))
            qa_pairs.append({"id": qid, "question": example["question"],
                             "answers": [example["answer"]],
                             "supporting_facts": supporting_facts})
    train, dev, test = _split(orig_train, orig_dev, num_dev)
    return corpus_records, qrels, train, dev, test


# -- test-only datasets ------------------------------------------------------------

def convert_simple_qa_tsv(path: str, skip_header: bool = False,
                          answers_are_python_literals: bool = False) -> List[dict]:
    """Question/answers TSV -> qa_pairs records (webqa/bamboogle,
    reference :304-362)."""
    import ast

    rows = load_tsv(path)
    if skip_header:
        rows = rows[1:]
    qa_pairs = []
    for row in rows:
        if answers_are_python_literals:
            answers = ast.literal_eval(row[1])
        else:
            answers = [row[-1]]
        qa_pairs.append({"question": row[0], "answers": list(answers)})
    return qa_pairs


# -- comparison maps -----------------------------------------------------------------

def load_comparison_map(raw_files: List[str]) -> Dict[str, bool]:
    """qid -> is-comparison from raw hotpotqa/2wiki files (reference :378-414)."""
    out: Dict[str, bool] = {}
    for f in raw_files:
        for example in load_json(f):
            out[example["_id"]] = example.get("type") == "comparison"
    return out


# -- CLI --------------------------------------------------------------------------------

PROCESS_MAP = {
    "2wikimultihopqa": process_2wikimultihopqa,
    "musique": process_musique,
    "hotpotqa": process_hotpotqa,
}


def main(argv: Optional[Sequence[str]] = None):
    """Run the CLI on ``argv`` (default: the command line)."""
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--dataset", type=str, required=True,
                        choices=list(PROCESS_MAP) + ["webqa", "bamboogle"])
    parser.add_argument("--raw_dir", type=str, required=True)
    parser.add_argument("--save_dir", type=str, required=True)
    parser.add_argument("--num_dev_data", type=int, default=500)
    args = parser.parse_args(argv)
    os.makedirs(args.save_dir, exist_ok=True)

    if args.dataset == "webqa":
        qa = convert_simple_qa_tsv(os.path.join(args.raw_dir, "webquestions-test.qa.csv"),
                                   answers_are_python_literals=True)
        save_json(qa, os.path.join(args.save_dir, "test_qa_pairs.json"), use_indent=True)
        return
    if args.dataset == "bamboogle":
        qa = convert_simple_qa_tsv(os.path.join(args.raw_dir, "Bamboogle_Prerelease.tsv"),
                                   skip_header=True)
        save_json(qa, os.path.join(args.save_dir, "test_qa_pairs.json"), use_indent=True)
        return

    corpus, qrels, train, dev, test = PROCESS_MAP[args.dataset](
        args.raw_dir, num_dev=args.num_dev_data)
    save_json(corpus, os.path.join(args.save_dir, "corpus.json"))
    save_tsv(qrels, os.path.join(args.save_dir, "qrels.tsv"))
    save_json(train, os.path.join(args.save_dir, "train_qa_pairs.json"))
    save_json(dev, os.path.join(args.save_dir, "dev_qa_pairs.json"))
    save_json(test, os.path.join(args.save_dir, "test_qa_pairs.json"))

    if args.dataset in ("hotpotqa", "2wikimultihopqa"):
        raw_files = ([os.path.join(args.raw_dir, "hotpot_train_v1.1.json"),
                      os.path.join(args.raw_dir, "hotpot_dev_distractor_v1.json")]
                     if args.dataset == "hotpotqa" else
                     [os.path.join(args.raw_dir, "train.json"),
                      os.path.join(args.raw_dir, "dev.json")])
        cmp_map = load_comparison_map(raw_files)
        with open(os.path.join(args.save_dir, "is_comparison_map.pkl"), "wb") as f:
            pickle.dump(cmp_map, f)
    logger.info(f"wrote ODQA data for {args.dataset} to {args.save_dir}")


if __name__ == "__main__":
    main()
