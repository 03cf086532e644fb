"""Training datasets of the Reasoning Chain Aligner (port of
:mod:`kirag_tpu.data.datasets`, host code).

- :class:`RetrieverDataset`: generic (question, positive_ctxs) records.
- :class:`KGChainRetrieverSeqSampleDataset`: per example, the chain-prefix
  combinations over the gold supporting triples (any hop order for
  comparison questions), ``num_positives`` sampled chains and
  ``num_negatives`` hard negatives, queries rendered as
  ``"{question}\\nknowledge triples: {chain}."``.

Plain indexable Python objects; the draws come from ``random.Random(0)`` in
the reference's order, so both packages yield the same examples.
"""

from __future__ import annotations

import itertools
import os
import pickle
import random
from typing import List, Optional, Sequence, Union

from kirag_tpu_torch.utils.io import load_json


def convert_triples_to_sentences(triples: Union[str, List[str]]) -> Union[str, List[str]]:
    """Strip angle brackets and the first two ';' separators."""
    return_str = isinstance(triples, str)
    if return_str:
        triples = [triples]
    out = [t.replace("<", "").replace(">", "").replace(";", "", 2) for t in triples]
    return out[0] if return_str else out


class RetrieverDataset:
    def __init__(self, data_files: Union[str, List[str]], question_prefix: str = "question:",
                 title_prefix: str = "title:", passage_prefix: str = "context:", **kwargs):
        self.question_prefix = question_prefix
        self.title_prefix = title_prefix
        self.passage_prefix = passage_prefix
        self.kwargs = kwargs
        self.data = self.load_data(data_files)

    def load_data(self, data_files):
        if isinstance(data_files, str):
            data_files = [data_files]
        data = []
        for f in data_files:
            data.extend(load_json(f, type="json"))
        return [ex for ex in data if ex.get("positive_ctxs")]  # records with positives

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index):
        return self.data[index]


class KGChainRetrieverDataset(RetrieverDataset):
    QUERY_TEMPLATE_WITH_CHAIN = "{question_prefix} {question}\nknowledge triples: {chain}."
    QUERY_TEMPLATE_WO_CHAIN = "{question_prefix} {question}"

    def __init__(self, data_files, question_prefix: str = "", use_title: bool = False,
                 convert_triple_to_sentence: bool = False, num_positives: int = 2,
                 num_negatives: int = 10, is_train: bool = True, **kwargs):
        self.use_title = use_title
        self.convert_triple_to_sentence = convert_triple_to_sentence
        self.num_positives = num_positives
        self.num_negatives = num_negatives
        self.is_train = is_train
        super().__init__(data_files, question_prefix=question_prefix, **kwargs)

    def load_data(self, data_files):
        if isinstance(data_files, str):
            data_files = [data_files]
        data = []
        for f in data_files:
            data.extend(load_json(f, type="json"))
        return data

    def get_triples_texts(self, triples: Sequence[dict]) -> List[str]:
        texts = []
        for triple in triples:
            text = ""
            if self.use_title:
                text += "title: {} text: ".format(triple["title"])
            if self.convert_triple_to_sentence:
                text += convert_triples_to_sentences(triple["text"])
            else:
                text += triple["text"]
            texts.append(text)
        return texts


class KGChainRetrieverSeqSampleDataset(KGChainRetrieverDataset):
    """Sequential chain-prefix sampling over gold supporting triples.

    Each data folder holds ``train_aligner.json`` / ``dev_aligner.json`` and,
    for hotpotqa/2wikimultihopqa, ``is_comparison_map.pkl`` mapping question
    id -> bool (comparison questions admit any hop order).
    """

    def __init__(self, is_train: bool, data_folders: List[str], question_prefix: str = "",
                 use_title: bool = False, convert_triple_to_sentence: bool = False,
                 num_positives: int = 2, num_negatives: int = 10,
                 rng: Optional[random.Random] = None, **kwargs):
        files = [os.path.join(f, "train_aligner.json" if is_train else "dev_aligner.json")
                 for f in data_folders]
        super().__init__(files, question_prefix=question_prefix, use_title=use_title,
                         convert_triple_to_sentence=convert_triple_to_sentence,
                         num_positives=num_positives, num_negatives=num_negatives,
                         is_train=is_train, **kwargs)
        self.comparison_question_ids = self._load_comparison_ids(data_folders)
        self.rng = rng or random.Random(0)

    @staticmethod
    def _load_comparison_ids(data_folders):
        ids = set()
        for folder in data_folders:
            if "hotpotqa" in folder or "2wikimultihopqa" in folder:
                path = os.path.join(folder, "is_comparison_map.pkl")
                if os.path.exists(path):
                    with open(path, "rb") as f:
                        for qid, is_cmp in pickle.load(f).items():
                            if is_cmp:
                                ids.add(qid)
        return ids

    def chain_combinations(self, example) -> List[tuple]:
        """All valid chain-prefix index combinations."""
        num_hops = len(example["supporting_triples"])
        combos: List[tuple] = []
        for hop in range(num_hops):
            if example["id"] in self.comparison_question_ids:
                if hop == 0:
                    combos.extend((i,) for i in range(num_hops))
                    continue
                combos.extend(itertools.permutations(range(hop + 1)))
            else:
                combos.append(tuple(range(hop + 1)))
        return combos

    def __getitem__(self, index: int) -> List[dict]:
        example = self.data[index]
        combos = self.chain_combinations(example)
        if self.is_train:
            combos = self.rng.sample(combos, min(self.num_positives, len(combos)))

        results = []
        for combination in combos:
            positive_triples = [example["supporting_triples"][pos] for pos in combination]
            if len(positive_triples) == 1:
                query = self.QUERY_TEMPLATE_WO_CHAIN.format(
                    question_prefix=self.question_prefix, question=example["question"]).strip()
            else:
                query = self.QUERY_TEMPLATE_WITH_CHAIN.format(
                    question_prefix=self.question_prefix, question=example["question"],
                    chain=". ".join(self.get_triples_texts(positive_triples[:-1]))).strip()
            positive_passage = self.get_triples_texts(positive_triples[-1:])[0]

            candidates = []
            for values in example["hard_negative_triples"].values():
                candidates.extend(values)
            while 0 < len(candidates) < self.num_negatives:
                candidates.append(self.rng.choice(candidates))
            if self.is_train:
                negatives = self.rng.sample(candidates, min(self.num_negatives, len(candidates)))
            else:
                negatives = candidates

            results.append({
                "index": index,
                "question": query,
                "answers": example.get("answers", []),
                "positive_passage": positive_passage,
                "negative_passages": self.get_triples_texts(
                    [{"text": n["text"], "title": n.get("title", "")} if isinstance(n, dict)
                     else {"text": n, "title": ""} for n in negatives]),
            })
        return results
