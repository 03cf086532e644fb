"""KiRAG: the knowledge-driven iterative retrieval pipeline (port of
:mod:`kirag_tpu.pipeline.kirag`, itself a re-design of the reference `KiRAG`,
`knowledge_graph/models.py:1186-1676`). Per question it loops up to
``num_turns`` times:

1. dense-retrieve passages for the question (+ the latest chain triple),
2. decompose the accumulated documents into knowledge triples (LLM, cached),
3. rescore candidate triples with the trained Aligner bi-encoder against the
   query "{question}\\nknowledge triples: {chain}." (`models.py:1514-1542`):
   embeddings are computed on the device and cached across turns and
   questions, and the few-hundred-candidate ranking runs on the host,
4. extend each reasoning chain with the LLM constructor under a forced
   "Thought: <chain so far>" prefix (`models.py:1595-1629`),
5. reinforce triples matching the generated step by token-F1 (+0.5,
   `models.py:1464-1498`),

and finally ranks documents by the best score of any triple they contributed
(`models.py:1500-1512`). Host code only: the device work happens in the
retriever, the aligner and the generators it is given.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from kirag_tpu_torch.evaluation.metrics import f1_score
from kirag_tpu_torch.kg.triples import parse_triples_text, sent_tokenize
from kirag_tpu_torch.utils.io import hash_object

logger = logging.getLogger(__name__)

EXAMPLAR_TYPES = ("hotpotqa", "2wikimultihopqa", "musique", "nq", "tqa",
                  "webqa", "bamboogle", "wikipedia")


def load_chain_examplars(examplar_type: str):
    """Dataset -> (reasoning-chain examplars, triple-selection examplars);
    dispatch mirrors `knowledge_graph/models.py:1235-1253`."""
    if examplar_type not in EXAMPLAR_TYPES:
        raise KeyError(f"{examplar_type} is not a supported examplar type!")
    from kirag_tpu_torch.prompts import kg_selection as ks

    if examplar_type == "2wikimultihopqa":
        return (ks.WIKIMULTIHOPQA_REASONING_CHAIN_EXAMPLARS,
                ks.WIKIMULTIHOPQA_TRIPLE_SELECTION_EXAMPLARS)
    if examplar_type == "musique":
        return (ks.MUSIQUE_REASONING_CHAIN_EXAMPLARS,
                ks.MUSIQUE_TRIPLE_SELECTION_EXAMPLARS)
    return (ks.HOTPOTQA_REASONING_CHAIN_EXAMPLARS,
            ks.HOTPOTQA_TRIPLE_SELECTION_EXAMPLARS)


class KiRAG:
    CONSTRUCTOR_INSTRUCTION = ("Follow the examples to answer the input question by reasoning "
                               "step-by-step. Output both reasoning steps and the answer.")

    def __init__(self, retriever, kg_generator, constructor, aligner,
                 examplar_type: str = "hotpotqa", num_examplars: int = 5,
                 adaptive_examplars: bool = True, embedder=None,
                 num_turns: int = 5, topk: int = 10, num_candidate_triples: int = 20,
                 maximum_possible_choices: int = 100, use_title_in_triples: bool = False,
                 reasoning_chain_examplars: Optional[List[Dict]] = None,
                 reinforcement: str = "f1", **kwargs):
        """
        Args:
          retriever: DenseRetriever with indexer+corpus (passage retrieval).
          kg_generator: KGGenerator (doc -> triples).
          constructor: Generator (the reasoning-chain constructor LLM).
          aligner: DenseRetriever WITHOUT indexer (bi-encoder scorer) — the
            Reasoning Chain Aligner (`models.py:1277-1307`).
          embedder: optional embedder for adaptive examplar ranking (defaults
            to the aligner).
          reinforcement: how generated reasoning steps reinforce stored
            triples — "f1" (token-F1 + answer-string, the reference main
            loop's choice), "string" (exact <h; r; t> component match,
            `models.py:1378-1416`), or "similarity" (nearest stored triple
            by embedding, `models.py:1418-1462`).
        """
        self.retriever = retriever
        self.kg_generator = kg_generator
        self.constructor = constructor
        self.aligner = aligner
        self.embedder = embedder or aligner
        self.num_examplars = num_examplars
        self.adaptive_examplars = adaptive_examplars and self.embedder is not None
        self.num_turns = num_turns
        self.topk = topk
        self.num_candidate_triples = num_candidate_triples
        self.maximum_possible_choices = maximum_possible_choices
        self.use_title_in_triples = use_title_in_triples
        if reinforcement not in ("f1", "string", "similarity"):
            raise ValueError(f"unknown reinforcement mode: {reinforcement!r}")
        self.reinforcement = reinforcement
        self.kwargs = kwargs

        if reasoning_chain_examplars is not None:
            self.reasoning_chain_examplars = reasoning_chain_examplars
            self.triple_selection_examplars = []
        else:
            self.reasoning_chain_examplars, self.triple_selection_examplars = (
                load_chain_examplars(examplar_type))

        self.examplars_embeddings = None
        if self.adaptive_examplars:
            questions = [e["question"] for e in self.reasoning_chain_examplars]
            self.examplars_embeddings = np.asarray(
                self.embedder.calculate_query_embeddings(questions, max_length=128))
        # triple embeddings are reused across turns (the reference re-embeds
        # every accumulated triple each turn, `models.py:1534-1537`)
        self._triple_emb_cache: Dict[str, np.ndarray] = {}

    # -- examplars ---------------------------------------------------------------

    def rank_examplars(self, question: str) -> List[int]:
        return self.rank_examplars_batch([question])[0]

    def rank_examplars_batch(self, questions: List[str]) -> List[List[int]]:
        """One embed call ranks examplars for every question (the batched
        loop coalesces this; per-question it degenerates to the reference's
        `models.py:1309-1317`)."""
        if not self.adaptive_examplars:
            return [list(range(len(self.reasoning_chain_examplars)))
                    for _ in questions]
        q_emb = np.asarray(self.embedder.calculate_query_embeddings(
            questions, max_length=128))
        sims = q_emb @ self.examplars_embeddings.T
        return [np.argsort(-row, kind="stable").tolist() for row in sims]

    # -- bookkeeping ---------------------------------------------------------------

    @staticmethod
    def update_retrieved_documents(docids_to_scores: Dict[str, float],
                                   retrieved_documents: List[List[dict]]) -> Dict[str, float]:
        """Max-score merge of per-turn retrievals (`models.py:1319-1326`)."""
        for one_result in retrieved_documents:
            for doc in one_result:
                docid, score = doc["id"], doc["score"]
                docids_to_scores[docid] = max(docids_to_scores.get(docid, -1e9), score)
        return docids_to_scores

    @staticmethod
    def get_candidate_triples_from_documents(documents: List[dict]) -> List[dict]:
        """Flatten doc triples with provenance (`models.py:1328-1343`)."""
        triples = []
        for doc in documents:
            for t in doc.get("triples", []):
                triples.append({
                    "title": doc["title"],
                    "text": t["text"],
                    "reference": [doc["id"], t["sentence"]],
                })
        return triples

    def get_triple_text(self, triple: dict) -> str:
        if self.use_title_in_triples:
            return "title: {}, text: {}".format(triple["title"], triple["text"])
        return triple["text"]

    def update_retrieved_triples(self, id2score: Dict[str, float], id2triple: Dict[str, dict],
                                 triples: List[dict], triples_indices: List[List[int]],
                                 triples_scores: Optional[List[List[float]]]
                                 ) -> Tuple[Dict[str, float], Dict[str, dict]]:
        """Hash-dedup + max-score accumulation (`models.py:1357-1376`)."""
        if triples_scores is None:
            triples_scores = [[1.0] * len(indices) for indices in triples_indices]
        for indices, scores in zip(triples_indices, triples_scores):
            for idx, score in zip(indices, scores):
                triple = triples[idx]
                triple_id = hash_object(triple)[:20]
                id2score[triple_id] = max(id2score.get(triple_id, -1e9), score)
                id2triple[triple_id] = triple
        return id2score, id2triple

    def update_reasoning_chains_triples_based_on_f1_score(
            self, id2score: Dict[str, float], id2triple: Dict[str, dict],
            triples: List[str]) -> Tuple[Dict[str, float], Dict[str, dict]]:
        """+0.5 to the best-F1 (>=0.6) stored triple per generated step, and
        +0.5 to the first stored triple containing a generated answer string
        (`models.py:1464-1498`)."""
        if not triples:
            return id2score, id2triple
        sorted_ids = sorted(id2score.keys(), key=lambda x: id2score[x], reverse=True)
        for triple in triples:
            low = triple.lower()
            if len(triple) == 0 or "answer is: yes" in low or "answer is: no" in low:
                continue
            if parse_triples_text(triple):
                scores = [f1_score(triple, id2triple[tid]["text"])[0] for tid in sorted_ids]
                if scores and max(scores) >= 0.6:
                    id2score[sorted_ids[int(np.argmax(scores))]] += 0.5
            if "answer is:" in triple:
                answer = triple.split("answer is:")[1].strip()
                for tid in sorted_ids:
                    if answer.lower() in id2triple[tid]["text"].lower():
                        id2score[tid] += 0.5
                        break
        return id2score, id2triple

    def update_reasoning_chains_triples_based_on_string(
            self, id2score: Dict[str, float], id2triple: Dict[str, dict],
            triples: List[str]) -> Tuple[Dict[str, float], Dict[str, dict]]:
        """Exact-match reinforcement (`models.py:1378-1416`): +0.5 to the
        first stored triple whose <h; r; t> components equal the parsed
        generated step, case/whitespace-insensitively."""
        if not triples:
            return id2score, id2triple

        def components(text: str):
            parts = text.replace("<", "").replace(">", "").split(";")
            if len(parts) != 3:
                return None
            return tuple(p.strip().lower() for p in parts)

        stored = [(tid, components(t["text"])) for tid, t in id2triple.items()]
        for triple in triples:
            parsed = parse_triples_text(triple)
            if not parsed:
                continue
            target = components(parsed[0])
            if target is None:
                continue
            for tid, comp in stored:
                if comp is not None and comp == target:
                    id2score[tid] += 0.5
                    break
        return id2score, id2triple

    def update_reasoning_chains_triples_based_on_similarity(
            self, id2score: Dict[str, float], id2triple: Dict[str, dict],
            triples: List[str]) -> Tuple[Dict[str, float], Dict[str, dict]]:
        """Embedding-similarity reinforcement (`models.py:1418-1462`): each
        non-empty, non-yes/no generated step adds +0.5 to its nearest stored
        triple by aligner-embedding inner product. The reference threads an
        incremental (index2id, embeddings) state through the loop; here the
        cross-turn triple-embedding cache makes stored-triple embeddings
        free to re-assemble, so no extra state is carried."""
        if not triples or not id2triple:
            return id2score, id2triple
        ids = list(id2triple.keys())
        stored = self._triple_embeddings([id2triple[t]["text"] for t in ids])
        steps = [t for t in triples
                 if len(t) > 0 and "answer is: yes" not in t.lower()
                 and "answer is: no" not in t.lower()]
        if not steps:
            return id2score, id2triple
        step_emb = self._triple_embeddings(steps)
        nearest = np.argmax(step_emb @ stored.T, axis=1)
        for row in nearest:
            id2score[ids[int(row)]] += 0.5
        return id2score, id2triple

    @staticmethod
    def get_triples(id2score: Dict[str, float], id2triple: Dict[str, dict]) -> List[dict]:
        return [id2triple[tid] for tid, _ in
                sorted(id2score.items(), key=lambda x: x[1], reverse=True)]

    @staticmethod
    def get_docids_to_scores_from_triples(id2score: Dict[str, float],
                                          id2triple: Dict[str, dict],
                                          max_num_docs: Optional[int] = None
                                          ) -> Dict[str, float]:
        """Rank docs by the best score of any triple they contributed
        (`models.py:1500-1512`)."""
        docids_to_scores: Dict[str, float] = {}
        for tid, score in id2score.items():
            docid = id2triple[tid]["reference"][0]
            docids_to_scores[docid] = max(docids_to_scores.get(docid, -1e9), score)
        ranked = sorted(docids_to_scores.items(), key=lambda x: x[1], reverse=True)
        if max_num_docs:
            ranked = ranked[:max_num_docs]
        return dict(ranked)

    # -- aligner scoring --------------------------------------------------------------

    def _triple_embeddings(self, triples_texts: List[str]) -> np.ndarray:
        """Embed triples through the aligner with a cross-turn cache (each
        accumulated triple is embedded once per question, not once per turn)."""
        if len(self._triple_emb_cache) > 100_000:  # bound memory on long runs
            self._triple_emb_cache.clear()
        missing = [t for t in triples_texts if t not in self._triple_emb_cache]
        if missing:
            emb = np.asarray(self.aligner.calculate_document_embeddings(
                missing, max_length=128))
            for text, e in zip(missing, emb):
                self._triple_emb_cache[text] = e
        return np.stack([self._triple_emb_cache[t] for t in triples_texts])

    def _aligner_queries(self, question: str,
                         reasoning_chains: List[List[dict]]) -> List[str]:
        """The aligner's query template per chain (`models.py:1514-1542`)."""
        chains_texts = ([[self.get_triple_text(t) for t in chain] for chain in reasoning_chains]
                        if reasoning_chains else [[]])
        return ["{}\nknowledge triples: {}.".format(question, ". ".join(texts))
                for texts in chains_texts]

    def _rank_candidates(self, q_emb: np.ndarray, triples: List[dict],
                         num_candidate_triples: int
                         ) -> Tuple[List[List[int]], List[List[float]]]:
        """Host-side ranking of the small candidate set against pre-computed
        query embeddings (cached triple embeddings supply the doc side)."""
        triples_texts = [self.get_triple_text(t) for t in triples]
        d_emb = self._triple_embeddings(triples_texts)
        scores = q_emb @ d_emb.T  # [num_chains, num_triples] — host, tiny
        k = min(num_candidate_triples, len(triples))
        order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
        top_scores = np.take_along_axis(scores, order, axis=1)
        return order.tolist(), top_scores.tolist()

    def filter_candidate_triples(self, question: str,
                                 reasoning_chains: List[List[dict]],
                                 triples: List[dict], num_candidate_triples: int
                                 ) -> Tuple[List[List[int]], List[List[float]]]:
        """Aligner rescoring (`models.py:1514-1542`): embed on the device
        (shape-bucketed), rank the small candidate set on the host."""
        queries = self._aligner_queries(question, reasoning_chains)
        q_emb = np.asarray(self.aligner.calculate_query_embeddings(queries, max_length=256))
        return self._rank_candidates(q_emb, triples, num_candidate_triples)

    # -- constructor --------------------------------------------------------------------

    def get_constructor_inputs(self, question: str, triples: List[dict],
                               ranked_examplars_indices: List[int]):
        instruction = self.CONSTRUCTOR_INSTRUCTION
        if self.num_examplars > 0:
            examplars = []
            for index in ranked_examplars_indices[: self.num_examplars]:
                item = self.reasoning_chain_examplars[index]
                thought = ". ".join(t.strip() for t in item["chains"].split(","))
                examplars.append("Question: {}\nThought: {}. So the answer is: {}".format(
                    item["question"], thought, item["answer"]))
            instruction += "\n\nExamples:\n\n" + "\n\n".join(examplars)
        user_input = "\n".join(self.get_triple_text(t) for t in triples)
        user_input += "\n\nQuestion: {}".format(question)
        return [instruction], [user_input.strip()]

    def get_constructor_documents_inputs(self, question: str, documents: List[dict],
                                         ranked_examplars_indices: List[int]):
        instruction = self.CONSTRUCTOR_INSTRUCTION
        if self.num_examplars > 0:
            examplars = []
            for index in ranked_examplars_indices[: self.num_examplars]:
                item = self.reasoning_chain_examplars[index]
                thought = ". ".join(t.strip() for t in item["chains"].split(","))
                examplars.append("Question: {}\nThought: {}. So the answer is: {}".format(
                    item["question"], thought, item["answer"]))
            instruction += "\n\nExamples:\n\n" + "\n\n".join(examplars)
        user_input = "\n\n".join(
            "Wikipedia Title: {}\n{}".format(
                doc["title"],
                doc["text"] if "text" in doc else " ".join(doc["sentences"]))
            for doc in documents)
        user_input += "\n\nQuestion: {}".format(question)
        return [instruction], [user_input.strip()]

    def _constructor_prompts(self, question: str, triples: List[dict],
                             reasoning_chains: List[List[str]],
                             documents: Optional[List[dict]],
                             ranked_examplars_indices: Optional[List[int]]
                             ) -> Tuple[List[str], List[str], List[str]]:
        """(instructions, inputs, forced "Thought:" prefixes) for one
        question's chains — one prompt per chain, so batches concatenate."""
        instructions, inputs = self.get_constructor_inputs(
            question, triples, ranked_examplars_indices)
        if documents is not None:
            doc_inst, doc_input = self.get_constructor_documents_inputs(
                question, documents, ranked_examplars_indices)
            instructions.extend(doc_inst)
            inputs.extend(doc_input)
        forced = ["Thought: " + ". ".join(chain) for chain in reasoning_chains]
        return instructions, inputs, forced

    @staticmethod
    def _apply_constructor_outputs(reasoning_chains: List[List[str]],
                                   texts: List[str]) -> List[List[str]]:
        """Append each decoded step (parsed triple, else first sentence) to
        its chain (`models.py:1620-1628`)."""
        for chain, text in zip(reasoning_chains, texts):
            generated = parse_triples_text(text)
            if generated:
                chain.append(generated[0])
            elif len(text) > 0:
                chain.append(sent_tokenize(text)[0])
            else:
                chain.append(text)
        return reasoning_chains

    def _decode_constructor(self, instructions: List[str], inputs: List[str],
                            forced: List[str],
                            prefix_groups: Optional[List[str]] = None
                            ) -> List[str]:
        # prefix_groups (one key per row, we use the question) lets a
        # prefix-caching backend reuse the (instruction + ranked examplars)
        # K/V across this question's turns and beams; backends without the
        # capability ignore the hint
        ids, _ = self.constructor.generator_generate(
            instructions, inputs, current_generated_texts=forced,
            max_new_tokens=self.constructor.max_new_tokens,
            prefix_groups=prefix_groups,
            return_logits=False)  # the constructor loop only parses text
        texts = self.constructor.tokenizer.batch_decode(ids, skip_special_tokens=True)
        return [t.strip().lstrip(".,;").strip() for t in texts]

    def one_retrieval(self, question: str, triples: List[dict],
                      reasoning_chains: List[List[str]],
                      documents: Optional[List[dict]] = None,
                      ranked_examplars_indices: Optional[List[int]] = None
                      ) -> List[List[str]]:
        """One constructor step per chain under the forced "Thought: <chain>"
        prefix; appends the parsed next triple (or first sentence) to each
        chain (`models.py:1595-1629`)."""
        instructions, inputs, forced = self._constructor_prompts(
            question, triples, reasoning_chains, documents,
            ranked_examplars_indices)
        texts = self._decode_constructor(instructions, inputs, forced,
                                         prefix_groups=[question] * len(forced))
        return self._apply_constructor_outputs(reasoning_chains, texts)

    # -- the loop ---------------------------------------------------------------------------

    def retrieve(self, question: str, num_beams: int = 1, **kwargs
                 ) -> Tuple[List[List[str]], Dict[str, float]]:
        """Main iterative loop (`models.py:1631-1676`). Returns
        (reasoning_chains, docid -> score ranked dict)."""
        assert num_beams in (1, 2), "num_beams must be 1 or 2"
        ranked_examplars_indices = self.rank_examplars(question)
        reasoning_chains: List[List[str]] = [[] for _ in range(num_beams)]
        docids_to_scores: Dict[str, float] = {}
        id2score: Dict[str, float] = {}
        id2triple: Dict[str, dict] = {}

        for turn in range(self.num_turns):
            if turn > 0 and all(len(chain[-1]) == 0 for chain in reasoning_chains):
                break
            queries = ([question] * num_beams if turn == 0 else
                       [question + " " + chain[-1] if chain else question
                        for chain in reasoning_chains])
            retrieved = self.retriever(queries, topk=self.topk)
            docids_to_scores = self.update_retrieved_documents(docids_to_scores, retrieved)
            documents = self.retriever.get_documents(docids_to_scores)
            documents_with_kgs = self.kg_generator(documents)
            all_triples = self.get_candidate_triples_from_documents(documents_with_kgs)
            if not all_triples:
                break

            chains_as_triples = [[{"title": "", "text": t} for t in chain]
                                 for chain in reasoning_chains]
            cand_indices, cand_scores = self.filter_candidate_triples(
                question, chains_as_triples, all_triples, self.num_candidate_triples)
            id2score, id2triple = self.update_retrieved_triples(
                id2score, id2triple, all_triples, cand_indices, cand_scores)

            candidate_triples = self.get_triples(id2score, id2triple)
            candidate_triples = candidate_triples[: self.maximum_possible_choices]
            reasoning_chains = self.one_retrieval(
                question=question,
                triples=candidate_triples,
                reasoning_chains=reasoning_chains,
                documents=documents if num_beams == 2 else None,
                ranked_examplars_indices=ranked_examplars_indices,
            )
            new_steps = [chain[turn] for chain in reasoning_chains if len(chain) > turn]
            reinforce = {
                "f1": self.update_reasoning_chains_triples_based_on_f1_score,
                "string": self.update_reasoning_chains_triples_based_on_string,
                "similarity": self.update_reasoning_chains_triples_based_on_similarity,
            }[self.reinforcement]
            id2score, id2triple = reinforce(id2score, id2triple, new_steps)

        if id2score:
            docids_to_scores = self.get_docids_to_scores_from_triples(id2score, id2triple)
        else:
            # no triples were ever extracted (e.g. the KG LLM produced nothing
            # parseable): fall back to the dense-retrieval scores instead of
            # returning nothing (the reference returns {} here)
            docids_to_scores = dict(
                sorted(docids_to_scores.items(), key=lambda x: x[1], reverse=True))
        return reasoning_chains, docids_to_scores

    # -- the batched loop ---------------------------------------------------------------

    def retrieve_batch(self, questions: List[str], num_beams: int = 1, **kwargs
                       ) -> List[Tuple[List[List[str]], Dict[str, float]]]:
        """Run :meth:`retrieve` for N questions in LOCKSTEP turns, coalescing
        every device stage across the in-flight questions (a redesign of the
        reference's sequential per-question loop, `retrieve.py:72-84`):

        - one retriever batch per turn (N*num_beams queries),
        - one KG-generation sweep per turn over the UNION of accumulated
          documents (deduped by doc id; decode batches fill
          ``kg_generator.batch_size`` instead of one question's trickle),
        - one aligner query-embedding batch + one triple-embedding batch,
        - one constructor decode batch (N*num_beams forced-prefix chains).

        Decode reads every weight once a step whatever the batch, so a
        wider decode batch costs little more per step. Per-question results
        are the same as the sequential loop: every stage is either
        per-question host math or a batched device call over independent
        rows. Returns one (reasoning_chains, docid->score) pair per
        question, in input order.
        """
        assert num_beams in (1, 2), "num_beams must be 1 or 2"
        ranked = self.rank_examplars_batch(questions)
        states = [{
            "question": q,
            "ranked": r,
            "chains": [[] for _ in range(num_beams)],
            "docids_to_scores": {},
            "id2score": {},
            "id2triple": {},
            "active": True,
        } for q, r in zip(questions, ranked)]

        for turn in range(self.num_turns):
            for s in states:
                if s["active"] and turn > 0 and all(
                        len(chain[-1]) == 0 for chain in s["chains"]):
                    s["active"] = False
            live = [s for s in states if s["active"]]
            if not live:
                break

            # ---- retrieval: one device batch across questions
            per_q = []
            for s in live:
                if turn == 0:
                    per_q.append([s["question"]] * num_beams)
                else:
                    per_q.append([s["question"] + " " + chain[-1] if chain
                                  else s["question"] for chain in s["chains"]])
            flat = [q for qs in per_q for q in qs]
            retrieved = self.retriever(flat, topk=self.topk)
            ofs = 0
            for s, qs in zip(live, per_q):
                s["docids_to_scores"] = self.update_retrieved_documents(
                    s["docids_to_scores"], retrieved[ofs: ofs + len(qs)])
                s["documents"] = self.retriever.get_documents(s["docids_to_scores"])
                ofs += len(qs)

            # ---- KG generation: one sweep over the union of documents
            union: Dict[str, dict] = {}
            for s in live:
                for doc in s["documents"]:
                    union.setdefault(doc["id"], doc)
            docs_with_kgs = self.kg_generator(list(union.values()))
            kg_by_id = {doc["id"]: doc for doc in docs_with_kgs}
            for s in live:
                s["documents_with_kgs"] = [kg_by_id[d["id"]] for d in s["documents"]]
                s["all_triples"] = self.get_candidate_triples_from_documents(
                    s["documents_with_kgs"])
                if not s["all_triples"]:
                    s["active"] = False  # == the sequential loop's break
            live = [s for s in states if s["active"] and "all_triples" in s
                    and s["all_triples"]]
            if not live:
                break

            # ---- aligner rescoring: one query-embed batch + one triple-
            # embed batch (the cross-question cache fill), host ranking each
            q_batch, q_counts = [], []
            triple_texts: Dict[str, None] = {}
            for s in live:
                chains_as_triples = [[{"title": "", "text": t} for t in chain]
                                     for chain in s["chains"]]
                qs = self._aligner_queries(s["question"], chains_as_triples)
                q_batch.extend(qs)
                q_counts.append(len(qs))
                for t in s["all_triples"]:
                    triple_texts.setdefault(self.get_triple_text(t))
            q_emb = np.asarray(self.aligner.calculate_query_embeddings(
                q_batch, max_length=256))
            if triple_texts:
                self._triple_embeddings(list(triple_texts))  # fill cache once
            ofs = 0
            for s, cnt in zip(live, q_counts):
                cand_indices, cand_scores = self._rank_candidates(
                    q_emb[ofs: ofs + cnt], s["all_triples"],
                    self.num_candidate_triples)
                ofs += cnt
                s["id2score"], s["id2triple"] = self.update_retrieved_triples(
                    s["id2score"], s["id2triple"], s["all_triples"],
                    cand_indices, cand_scores)

            # ---- constructor: one forced-prefix decode batch
            instructions, inputs, forced, groups = [], [], [], []
            row_groups: List[str] = []
            for s in live:
                candidate_triples = self.get_triples(s["id2score"], s["id2triple"])
                candidate_triples = candidate_triples[: self.maximum_possible_choices]
                inst, inp, f = self._constructor_prompts(
                    s["question"], candidate_triples, s["chains"],
                    s["documents"] if num_beams == 2 else None, s["ranked"])
                instructions.extend(inst)
                inputs.extend(inp)
                forced.extend(f)
                groups.append(len(f))
                row_groups.extend([s["question"]] * len(f))
            texts = self._decode_constructor(instructions, inputs, forced,
                                             prefix_groups=row_groups)
            ofs = 0
            reinforce = {
                "f1": self.update_reasoning_chains_triples_based_on_f1_score,
                "string": self.update_reasoning_chains_triples_based_on_string,
                "similarity": self.update_reasoning_chains_triples_based_on_similarity,
            }[self.reinforcement]
            for s, cnt in zip(live, groups):
                s["chains"] = self._apply_constructor_outputs(
                    s["chains"], texts[ofs: ofs + cnt])
                ofs += cnt
                new_steps = [chain[turn] for chain in s["chains"]
                             if len(chain) > turn]
                s["id2score"], s["id2triple"] = reinforce(
                    s["id2score"], s["id2triple"], new_steps)

        results = []
        for s in states:
            if s["id2score"]:
                ranked_docs = self.get_docids_to_scores_from_triples(
                    s["id2score"], s["id2triple"])
            else:
                ranked_docs = dict(sorted(s["docids_to_scores"].items(),
                                          key=lambda x: x[1], reverse=True))
            results.append((s["chains"], ranked_docs))
        return results
