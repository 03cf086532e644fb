"""TripleSelector: LLM-as-multiple-choice selector with option-probability beam
(port of :mod:`kirag_tpu.pipeline.selector`).

A clean re-design of the reference's experimental `TripleSelector`
(`knowledge_graph/models.py:33-1183`, minus its dead code paths): instead of
asking the constructor LLM to free-generate the next triple, candidates are
presented as numbered choices ("0" = stop) and the NEXT-chain beam expands by
the LLM's probability mass over the option tokens at the first option
position (`get_option_tokens_probs`, reference :861-888; beam expansion
:986-1100).

State per chain: ``{"triples": [...], "score": float, "finished": bool}``.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

import numpy as np

from kirag_tpu_torch.pipeline.kirag import KiRAG

logger = logging.getLogger(__name__)

STOP_CHOICE_TEXT = "no need for additional knowledge triples"


class TripleSelector(KiRAG):
    """Extends the KiRAG machinery with an option-token selection step."""

    SELECTOR_INSTRUCTION = (
        "Select the next knowledge triple that extends an existing set of knowledge "
        "triples to form a coherent reasoning path capable of answering a specified "
        "question. If the current reasoning path is sufficient to answer the question, "
        "simply output 0. Please only output the choice for the next knowledge triple.")

    def __init__(self, *args, num_selector_examplars: int = 3, max_new_tokens: int = 8,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.num_selector_examplars = num_selector_examplars
        self.selector_max_new_tokens = max_new_tokens

    # -- prompt -----------------------------------------------------------------

    @staticmethod
    def convert_candidate_triples_to_choices(candidates: List[str]) -> List[str]:
        choices = ["0. " + STOP_CHOICE_TEXT]
        choices.extend(f"{i + 1}. {c}" for i, c in enumerate(candidates))
        return choices

    def get_selector_inputs(self, question: str, existing_triples: List[List[str]],
                            candidate_triples: List[List[str]]) -> Tuple[List[str], List[str]]:
        examplar_blocks = []
        for item in self.triple_selection_examplars[: self.num_selector_examplars]:
            block = "Question: {}\nExisting knowledge triples: {}\nCandidate knowledge triples:\n{}\nThe next knowledge triple: {}".format(
                item["question"], ". ".join(item["triples"]),
                "\n".join(item["candidate_triples"]), item["answer"])
            examplar_blocks.append(block)
        instruction = self.SELECTOR_INSTRUCTION
        if examplar_blocks:
            instruction += "\n\nExamples:\n\n" + "\n\n".join(examplar_blocks)

        instructions, inputs = [], []
        for chain_triples, chain_candidates in zip(existing_triples, candidate_triples):
            choices = self.convert_candidate_triples_to_choices(chain_candidates)
            user_input = "Question: {}\nExisting knowledge triples: {}\nCandidate knowledge triples:\n{}\nThe next knowledge triple: ".format(
                question, ". ".join(chain_triples), "\n".join(choices))
            instructions.append(instruction)
            inputs.append(user_input)
        return instructions, inputs

    # -- option probabilities -----------------------------------------------------

    def get_option_token_id_to_option_map(self, num_options: int) -> Dict[int, str]:
        """token id -> option string, covering "N" and " N" tokenizations
        (reference `models.py:827-841`).

        Unlike the reference (which maps `encode(option)[-1]`, letting "10"
        hijack the digit token of "0"), an option is only mapped when it
        tokenizes to a SINGLE token, and earlier (smaller) options win on
        collisions — the stop choice "0" can never be shadowed. Multi-token
        options are unrepresentable by a one-token probe and are skipped.
        """
        tokenizer = self.constructor.tokenizer
        out: Dict[int, str] = {}
        for i in range(num_options):
            option = str(i)
            for text in (option, f" {option}"):
                ids = tokenizer.encode(text, add_special_tokens=False)
                if len(ids) == 1 and ids[0] not in out:
                    out[ids[0]] = option
        return out

    def get_option_tokens_probs(self, token_ids: np.ndarray, token_logits: np.ndarray,
                                num_options: int) -> Tuple[List[str], np.ndarray]:
        """Probability over option tokens at the FIRST generated option position
        per row; rows with no option token get NaN (reference :861-888)."""
        option_map = self.get_option_token_id_to_option_map(num_options)
        n = len(token_ids)
        option_token_ids = list(option_map.keys())
        option_tokens = [option_map[t] for t in option_token_ids]

        probs = np.full((n, len(option_token_ids)), np.nan, dtype=np.float32)
        for i in range(n):
            pos = None
            for j in range(token_ids.shape[1]):
                if int(token_ids[i, j]) in option_map:
                    pos = j
                    break
            if pos is None:
                continue
            logits = token_logits[i, pos, option_token_ids].astype(np.float64)
            e = np.exp(logits - logits.max())
            probs[i] = (e / e.sum()).astype(np.float32)
        return option_tokens, probs

    # -- candidate dedup ------------------------------------------------------------

    def filter_duplicate_triples(self, chains: List[List[dict]], all_triples: List[dict],
                                 indices: List[List[int]],
                                 scores: Optional[List[List[float]]]):
        """Drop candidates already present in each chain (reference :522-560)."""
        if scores is None:
            scores = [[1.0] * len(ix) for ix in indices]
        out_idx, out_scores = [], []
        for chain, ix_row, sc_row in zip(chains, indices, scores):
            existing = {t["text"] for t in chain}
            keep_i, keep_s = [], []
            for ix, sc in zip(ix_row, sc_row):
                if all_triples[ix]["text"] not in existing:
                    keep_i.append(ix)
                    keep_s.append(sc)
            out_idx.append(keep_i)
            out_scores.append(keep_s)
        return out_idx, out_scores

    # -- one selection step --------------------------------------------------------

    def select(self, question: str, documents: List[dict],
               existing_reasoning_chains: Optional[List[dict]] = None,
               num_beams: int = 5, max_num_chains: Optional[int] = None,
               min_triple_prob: float = 1e-4) -> List[dict]:
        """One beam-expansion step over the candidate triples of ``documents``
        (which must already carry ``triples``). Returns ranked chain states."""
        if existing_reasoning_chains:
            chains = [c["triples"] for c in existing_reasoning_chains]
            chains_scores = [c["score"] for c in existing_reasoning_chains]
            chains_finished = [c["finished"] for c in existing_reasoning_chains]
            if all(chains_finished):
                return existing_reasoning_chains
        else:
            chains, chains_scores, chains_finished = [[]], [1.0], [False]

        all_triples = self.get_candidate_triples_from_documents(documents)
        if self.aligner is not None and all_triples:
            cand_indices, cand_scores = self.filter_candidate_triples(
                question, chains, all_triples, self.num_candidate_triples)
        else:
            cand_indices = [list(range(min(len(all_triples), self.maximum_possible_choices)))
                            for _ in chains]
            cand_scores = None
        cand_indices, cand_scores = self.filter_duplicate_triples(
            chains, all_triples, cand_indices, cand_scores)
        max_num_candidates = max((len(ix) for ix in cand_indices), default=0)

        existing_texts = [[self.get_triple_text(t) for t in chain] for chain in chains]
        candidate_texts = [[self.get_triple_text(all_triples[ix]) for ix in ix_row]
                           for ix_row in cand_indices]
        instructions, inputs = self.get_selector_inputs(
            question, existing_texts, candidate_texts)
        token_ids, token_logits = self.constructor.generator_generate(
            instructions, inputs, max_new_tokens=self.selector_max_new_tokens)
        option_tokens, option_probs = self.get_option_tokens_probs(
            token_ids, token_logits, max_num_candidates + 1)

        new_chains: List[dict] = []
        k_beam = min(option_probs.shape[1], num_beams)
        for i, (chain, score, finished) in enumerate(
                zip(chains, chains_scores, chains_finished)):
            row = option_probs[i]
            if finished or len(cand_indices[i]) == 0:
                new_chains.append({"triples": chain, "score": score, "finished": True})
                continue
            if np.all(np.isnan(row)):
                logger.warning("no option token in generated output; keeping chain")
                new_chains.append({"triples": chain, "score": score, "finished": False})
                continue
            order = np.argsort(-np.nan_to_num(row, nan=-1.0))[:k_beam]
            for b in order:
                p = row[b]
                if np.isnan(p) or p < min_triple_prob:
                    continue
                choice = option_tokens[b]
                if choice != "0" and int(choice) > len(cand_indices[i]):
                    continue  # the model picked a choice beyond the menu
                if choice == "0":
                    new_chains.append({"triples": chain, "score": score * float(p),
                                       "finished": True})
                else:
                    nxt = all_triples[cand_indices[i][int(choice) - 1]]
                    new_chains.append({"triples": chain + [nxt],
                                       "score": score * float(p), "finished": False})

        new_chains.sort(key=lambda c: c["score"], reverse=True)
        return new_chains[:max_num_chains] if max_num_chains else new_chains

    # -- retriever-only beam (no LLM in the expansion step) --------------------------

    def select_wo_selector(self, question: str, documents: List[dict],
                           existing_reasoning_chains: Optional[List[dict]] = None,
                           num_beams: int = 5,
                           max_num_chains: Optional[int] = None,
                           return_triple_filter_scores: bool = False
                           ) -> List[dict]:
        """Retriever-only beam expansion (reference `forward_wo_selector`,
        `models.py:1102-1183`): each unfinished chain forks into its top
        ``num_beams`` aligner-scored candidates — no LLM call; a chain's
        score is the running SUM of its triples' aligner scores (vs the
        selector beam's product of option probabilities). Candidates at or
        below the reference's -1e4 sentinel stop the fork. One deliberate
        fix: ``triple_filter_scores`` is each chain's OWN per-step score
        list (the reference attaches the full list-of-lists to every row).
        """
        if existing_reasoning_chains:
            chains = [c["triples"] for c in existing_reasoning_chains]
            chains_scores = [c["score"] for c in existing_reasoning_chains]
            chains_finished = [c["finished"] for c in existing_reasoning_chains]
            chains_tfs = [list(c.get("triple_filter_scores", []))
                          for c in existing_reasoning_chains]
            if all(chains_finished):
                return existing_reasoning_chains
        else:
            chains, chains_scores = [[]], [0.0]
            chains_finished, chains_tfs = [False], [[]]

        all_triples = self.get_candidate_triples_from_documents(documents)
        if self.aligner is not None and all_triples:
            cand_indices, cand_scores = self.filter_candidate_triples(
                question, chains, all_triples, self.num_candidate_triples)
        else:
            # no aligner: unranked candidates with neutral scores (mirrors
            # select()'s fallback; the beam then degenerates to list order)
            cand_indices = [list(range(min(len(all_triples),
                                           self.maximum_possible_choices)))
                            for _ in chains]
            cand_scores = [[1.0] * len(ix) for ix in cand_indices]
        cand_indices, cand_scores = self.filter_duplicate_triples(
            chains, all_triples, cand_indices, cand_scores)

        new_chains: List[dict] = []
        for i, (chain, score, finished) in enumerate(
                zip(chains, chains_scores, chains_finished)):
            if finished or len(cand_indices[i]) == 0:
                new_chains.append({"triples": chain, "score": score,
                                   "finished": True,
                                   "triple_filter_scores": chains_tfs[i]})
                continue
            for ix, sc in list(zip(cand_indices[i], cand_scores[i]))[:num_beams]:
                if sc <= -1e4:
                    break
                new_chains.append({
                    "triples": chain + [all_triples[ix]],
                    "score": score + float(sc), "finished": False,
                    "triple_filter_scores": chains_tfs[i] + [float(sc)]})

        new_chains.sort(key=lambda c: c["score"], reverse=True)
        if not return_triple_filter_scores:
            for c in new_chains:
                c.pop("triple_filter_scores", None)
        return new_chains[:max_num_chains] if max_num_chains else new_chains

    # -- full retrieval with the selector --------------------------------------------

    def retrieve(self, question: str, num_beams: int = 5,
                 max_num_chains: int = 5, use_llm_selector: bool = True,
                 **kwargs):
        """Iterative retrieval where chain extension is the option-prob beam
        instead of free generation. ``use_llm_selector=False`` swaps in the
        retriever-only beam (:meth:`select_wo_selector`)."""
        docids_to_scores: Dict[str, float] = {}
        chains: List[dict] = []
        step = self.select if use_llm_selector else self.select_wo_selector
        for turn in range(self.num_turns):
            if chains and all(c["finished"] for c in chains):
                break
            queries = [question] if not chains else [
                question + " " + self.get_triple_text(c["triples"][-1])
                if c["triples"] else question for c in chains]
            retrieved = self.retriever(queries, topk=self.topk)
            docids_to_scores = self.update_retrieved_documents(docids_to_scores, retrieved)
            documents = self.retriever.get_documents(docids_to_scores)
            documents_with_kgs = self.kg_generator(documents)
            chains = step(question, documents_with_kgs,
                          existing_reasoning_chains=chains,
                          num_beams=num_beams, max_num_chains=max_num_chains)

        doc_scores: Dict[str, float] = {}
        for c in chains:
            for t in c["triples"]:
                docid = t["reference"][0]
                doc_scores[docid] = max(doc_scores.get(docid, -1e9), c["score"])
        if not doc_scores:
            doc_scores = dict(sorted(docids_to_scores.items(), key=lambda x: x[1],
                                     reverse=True))
        else:
            doc_scores = dict(sorted(doc_scores.items(), key=lambda x: x[1], reverse=True))
        return chains, doc_scores
