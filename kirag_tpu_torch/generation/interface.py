"""The narrow LLM generation contract + the text-level Generator harness (port
of :mod:`kirag_tpu.generation.interface`).

The reference `Generator` (`generator/generator.py:29-302`) exposes a small
contract the whole pipeline depends on: greedy generation returning token ids
AND per-step logits, stop-word early stopping, and forced-prefix continuation
(`generator_generate(..., current_generated_texts)` :271-302). This module
re-designs that contract around a pluggable token-level backend:

- ``backend.greedy(input_ids, attention_mask, max_new_tokens)`` ->
  (gen_ids [B, <=max_new], gen_logits [B, <=max_new, V]) — numpy in/out.
- Backends: :class:`kirag_tpu_torch.models.llm.TorchLlamaBackend` (decode loop),
  :class:`kirag_tpu_torch.generation.stub.StubBackend` (deterministic, for tests).

Forced prefixes are spliced at the TOKEN level — row ids are
``tok(prompt) ++ tok(prefix, add_special_tokens=False)``, then left-padded
once — reproducing the reference's token-splicing semantics
(`generator/utils.py:56-104`) without the repad-an-existing-batch dance
(we tokenize after knowing the prefix, so the splice is a concat). Text-level
concatenation would re-tokenize across the prompt/prefix boundary, where
byte-level BPE can merge tokens and silently change the conditioning
(tests/test_generation.py::TestForcedPrefixBoundaries). Stop-words are checked on
the host every ``stop_check_every`` generated tokens (segment-wise decode),
the reference's `StopWordCriteria` semantics (`generator/stop_word_criteria.py`)
without a per-token host sync.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Protocol, Sequence, Tuple, Union

import numpy as np

from kirag_tpu_torch.generation.chat import (
    build_messages,
    detect_family,
    detect_is_chat,
    render_chat,
)


@dataclasses.dataclass
class GenerationOutput:
    token_ids: np.ndarray      # [B, G] generated ids (pad after stop)
    logits: np.ndarray         # [B, G, V] per-step logits (0 after stop)
    texts: List[str]           # decoded generated texts (stop words trimmed off)


class Backend(Protocol):
    eos_token_id: int

    def greedy(self, input_ids: np.ndarray, attention_mask: np.ndarray,
               max_new_tokens: int, return_logits: bool = True
               ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        ...

    # Optional resumable extension (duck-typed; see TorchLlamaBackend):
    #   greedy_start(input_ids, attention_mask, total_new_tokens, return_logits)
    #     -> (ids [B,1], logits|None, state)
    #   greedy_resume(state, n_steps, return_logits) -> (ids, logits|None, state)


def pad_token_ids(token_ids: np.ndarray, max_length: int, pad_token_id: int) -> np.ndarray:
    """Right-pad generated ids to ``max_length`` (reference `generator/utils.py:8-18`)."""
    b, t = token_ids.shape
    if t >= max_length:
        return token_ids[:, :max_length]
    out = np.full((b, max_length), pad_token_id, dtype=token_ids.dtype)
    out[:, :t] = token_ids
    return out


def pad_token_logits(token_logits: np.ndarray, max_length: int) -> np.ndarray:
    """Right-pad per-step logits with zeros (reference `generator/utils.py:21-31`)."""
    b, t, v = token_logits.shape
    if t >= max_length:
        return token_logits[:, :max_length]
    out = np.zeros((b, max_length, v), dtype=token_logits.dtype)
    out[:, :t] = token_logits
    return out


class Generator:
    """Text-level generation harness over a token-level backend."""

    def __init__(self, tokenizer, backend: Backend, max_length: int = 4096,
                 max_new_tokens: int = 128, batch_size: int = 4,
                 model_name: str = "generic", is_chat: Optional[bool] = None,
                 stop_check_every: int = 16, **kwargs):
        self.tokenizer = tokenizer
        self.backend = backend
        self.max_length = max_length
        self.max_new_tokens = max_new_tokens
        self.batch_size = batch_size
        self.model_name = model_name
        self.family = detect_family(model_name)
        self.is_chat = detect_is_chat(model_name) if is_chat is None else is_chat
        self.stop_check_every = stop_check_every
        self.kwargs = kwargs

        if tokenizer.pad_token_id is None:
            raise ValueError(
                "tokenizer.pad_token_id is None; set pad_token to eos_token first")

    # -- prompt rendering -----------------------------------------------------

    def render_prompt(self, instruction: str, content, forced_prefix: Optional[str] = None) -> str:
        if self.is_chat:
            messages = build_messages(self.family, instruction, content)
            if hasattr(self.tokenizer, "apply_chat_template") and getattr(
                    self.tokenizer, "chat_template", None):
                text = self.tokenizer.apply_chat_template(
                    messages, tokenize=False, add_generation_prompt=True)
            else:
                text = render_chat(self.family, messages, add_generation_prompt=True)
        else:
            assert isinstance(content, str), "non-chat prompts take string content"
            text = instruction + "\n\n" + content
        if forced_prefix:
            # forced continuation: the model resumes after the prefix
            text = text + forced_prefix
        return text

    def prompt(self, instructions: List[str], inputs: List, **kwargs) -> List[str]:
        assert len(instructions) == len(inputs)
        return [self.render_prompt(inst, inp) for inst, inp in zip(instructions, inputs)]

    # -- tokenization ---------------------------------------------------------

    def tokenizer_encode(self, prompts: List[str], max_length: Optional[int] = None
                         ) -> Dict[str, np.ndarray]:
        max_length = max_length or self.max_length
        self.tokenizer.padding_side = "left"  # decoder-only: left padding
        # over-long prompts must lose their HEAD, not their tail — the tail
        # carries the question, the generation header, and any forced prefix
        self.tokenizer.truncation_side = "left"
        out = self.tokenizer(prompts, max_length=max_length, padding=True,
                             truncation=True, return_tensors="np",
                             add_special_tokens=not self.is_chat)
        return {"input_ids": out["input_ids"].astype(np.int32),
                "attention_mask": out["attention_mask"].astype(np.int32)}

    def tokenizer_encode_with_prefixes(self, prompts: List[str],
                                       prefixes: List[Optional[str]],
                                       max_length: Optional[int] = None
                                       ) -> Dict[str, np.ndarray]:
        """Token-level forced-prefix splice: each row is
        ``tok(prompt) ++ tok(prefix, add_special_tokens=False)`` — exactly
        the reference's `append_texts_to_decoder_only_generator_inputs`
        (`generator/utils.py:56-104`). Tokenizing the concatenated TEXT
        instead can merge tokens across the boundary (e.g. byte-level BPE
        joining a prompt-final newline with the prefix's first word), which
        would condition the model on a different token stream than the one
        it actually generated; the splice is boundary-exact by construction
        (pinned in tests/test_generation.py::TestForcedPrefixBoundaries)."""
        max_length = max_length or self.max_length
        specials = not self.is_chat
        rows = []
        for prompt, pre in zip(prompts, prefixes):
            ids = self.tokenizer(prompt, add_special_tokens=specials)["input_ids"]
            if pre:
                ids = ids + self.tokenizer(pre, add_special_tokens=False)["input_ids"]
            # over-long rows lose their HEAD (the tail carries the question,
            # the generation header, and the forced prefix) — same policy as
            # tokenizer_encode's truncation_side="left"
            rows.append(ids[-max_length:])
        width = max(len(r) for r in rows)
        pad_id = self.tokenizer.pad_token_id
        input_ids = np.full((len(rows), width), pad_id, dtype=np.int32)
        mask = np.zeros((len(rows), width), dtype=np.int32)
        for i, r in enumerate(rows):                     # left padding
            if r:
                input_ids[i, width - len(r):] = r
                mask[i, width - len(r):] = 1
        return {"input_ids": input_ids, "attention_mask": mask}

    # -- generation -------------------------------------------------------------

    def _trim_at_stop_words(self, text: str, stop_words: Sequence[str]) -> Tuple[str, bool]:
        earliest = None
        for w in stop_words:
            pos = text.find(w)
            if pos >= 0 and (earliest is None or pos < earliest):
                earliest = pos
        if earliest is None:
            return text, False
        return text[:earliest], True

    def greedy_generate(self, inputs: Dict[str, np.ndarray],
                        max_new_tokens: Optional[int] = None,
                        stop_words: Optional[Sequence[str]] = None,
                        batch_size: Optional[int] = None,
                        pad_to_max_new_tokens: bool = False,
                        return_logits: bool = True,
                        prefix_groups: Optional[Sequence] = None,
                        **kwargs) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Batched greedy decode returning (token_ids, per-step logits), the
        reference contract (`generator/generator.py:171-235`).

        ``return_logits=False`` skips materializing the [B, G, V] logits
        buffer entirely (returns None) — use it on text-only paths like the
        KiRAG constructor loop; only the TripleSelector needs logits.
        """
        max_new = max_new_tokens or self.max_new_tokens
        bsz = batch_size or self.batch_size
        n = len(inputs["input_ids"])
        # prefix KV reuse: only on the plain greedy path of a backend that
        # opts in (supports_prefix_cache: TorchLlamaBackend with a pool); the
        # segmented stop-word path and other backends ignore the hint
        use_prefix = (prefix_groups is not None and not stop_words
                      and getattr(self.backend, "supports_prefix_cache",
                                  False))
        if prefix_groups is not None:
            assert len(prefix_groups) == n

        ids_list, logits_list = [], []
        for start in range(0, n, bsz):
            batch = {k: v[start: start + bsz] for k, v in inputs.items()}
            groups = (list(prefix_groups[start: start + bsz])
                      if use_prefix else None)
            n_real = len(batch["input_ids"])
            # pad rows to a power-of-two bucket <= bsz: bounds the number of
            # compiled decode programs across varying request sizes
            n_pad = 1
            while n_pad < n_real:
                n_pad *= 2
            n_pad = min(n_pad, bsz)
            if n_pad > n_real:
                batch = {k: np.concatenate(
                    [v, np.repeat(v[-1:], n_pad - n_real, axis=0)]) for k, v in batch.items()}
                if groups is not None:
                    groups += [groups[-1]] * (n_pad - n_real)
            if stop_words and not getattr(self.backend, "is_encoder_decoder", False):
                # segment-wise stop checks on the decoder-only context; for
                # encoder-decoder backends growing the context would corrupt
                # the encoder input, so rely on EOS + post-hoc trim there
                gen_ids, gen_logits = self._segmented_greedy(
                    batch, max_new, stop_words, return_logits)
            elif groups is not None:
                gen_ids, gen_logits = self.backend.greedy(
                    batch["input_ids"], batch["attention_mask"], max_new,
                    return_logits=return_logits, prefix_groups=groups)
            else:
                gen_ids, gen_logits = self.backend.greedy(
                    batch["input_ids"], batch["attention_mask"], max_new,
                    return_logits=return_logits)
            ids_list.append(np.asarray(gen_ids)[:n_real])
            if return_logits:
                logits_list.append(np.asarray(gen_logits)[:n_real])

        max_len = max_new if pad_to_max_new_tokens else max(x.shape[1] for x in ids_list)
        pad_id = self.tokenizer.pad_token_id
        ids = np.concatenate([pad_token_ids(x, max_len, pad_id) for x in ids_list], axis=0)
        if not return_logits:
            return ids, None
        logits = np.concatenate([pad_token_logits(x, max_len) for x in logits_list], axis=0)
        return ids, logits

    class _StopTracker:
        """Incremental stop-word/eos detection across decode segments.

        Decodes only each NEW segment (plus a token overlap so a stop word
        spanning a segment boundary is still seen) — O(generated tokens)
        total host decode per generation instead of the naive
        O(segments x generated tokens) full re-decode each check. Rows are
        sticky: once a stop word or eos is seen the row never decodes again.
        """

        MIN_OVERLAP = 32  # floor; the actual overlap is sized from the
        # longest tokenized stop word so no spanning match can be missed

        def __init__(self, tokenizer, stop_words: Sequence[str],
                     eos_token_id: int, n_rows: int):
            self.tokenizer = tokenizer
            self.stop_words = stop_words
            self.eos_token_id = eos_token_id
            # a stop word spanning the boundary is fully contained in
            # (tail + new segment) as long as the tail keeps more tokens
            # than the word's own tokenization (+margin: retokenization of
            # a decoded window need not align with the original split)
            longest = max((len(tokenizer.encode(w, add_special_tokens=False))
                           for w in stop_words), default=0)
            self.overlap = max(self.MIN_OVERLAP, 2 * longest + 8)
            self.done = [False] * n_rows
            self._tails: List[np.ndarray] = [
                np.empty(0, dtype=np.int64)] * n_rows

        def update(self, new_ids: np.ndarray) -> List[bool]:
            for row in range(len(self.done)):
                if self.done[row]:
                    continue
                seg = np.asarray(new_ids[row])
                window = np.concatenate([self._tails[row], seg])
                text = self.tokenizer.decode(window, skip_special_tokens=True)
                if any(w in text for w in self.stop_words) or bool(
                        np.any(seg == self.eos_token_id)):
                    self.done[row] = True
                else:
                    self._tails[row] = window[-self.overlap:]
            return self.done

    def _segmented_greedy(self, batch, max_new: int, stop_words: Sequence[str],
                          return_logits: bool = True):
        """Generate in segments; after each, decode on host and stop when every
        row contains a stop word or eos (the reference's `StopWordCriteria`
        semantics, `generator/stop_word_criteria.py:7-59`, at segment
        granularity instead of per-token host syncs).

        Backends exposing the resumable API (``greedy_start``/``greedy_resume``)
        pay ONE prefill total: the KV cache stays on device between segments
        and each stop check costs only ``stop_check_every`` decode steps.
        Stateless backends fall back to re-prefilling the grown context.
        """
        input_ids = batch["input_ids"]
        attention_mask = batch["attention_mask"]
        seg = self.stop_check_every
        all_ids, all_logits = [], []
        tracker = self._StopTracker(self.tokenizer, stop_words,
                                    self.backend.eos_token_id,
                                    len(input_ids))

        if hasattr(self.backend, "greedy_resume"):
            # reserve 1 (prefill token) + full segments so every resume call
            # reuses ONE compiled program shape; surplus is trimmed below
            n_segs = -(-(max_new - 1) // seg) if max_new > 1 else 0
            total = 1 + n_segs * seg
            gen_ids, gen_logits, state = self.backend.greedy_start(
                input_ids, attention_mask, total, return_logits=return_logits)
            all_ids.append(gen_ids)
            all_logits.append(gen_logits)
            produced = gen_ids.shape[1]
            while produced < max_new:
                if all(tracker.update(np.asarray(gen_ids))):
                    break
                gen_ids, gen_logits, state = self.backend.greedy_resume(
                    state, seg, return_logits=return_logits)
                all_ids.append(gen_ids)
                all_logits.append(gen_logits)
                produced += gen_ids.shape[1]
            ids = np.concatenate(all_ids, axis=1)[:, :max_new]
            if not return_logits:
                return ids, None
            return ids, np.concatenate(all_logits, axis=1)[:, :max_new]

        produced = 0
        while produced < max_new:
            step = min(seg, max_new - produced)
            gen_ids, gen_logits = self.backend.greedy(
                input_ids, attention_mask, step, return_logits=return_logits)
            all_ids.append(np.asarray(gen_ids))
            all_logits.append(gen_logits)
            produced += gen_ids.shape[1]
            if all(tracker.update(np.asarray(gen_ids))):
                break
            # extend context with the generated segment for the next round
            input_ids = np.concatenate([input_ids, np.asarray(gen_ids)], axis=1)
            attention_mask = np.concatenate(
                [attention_mask, np.ones_like(np.asarray(gen_ids))], axis=1)
        ids = np.concatenate(all_ids, axis=1)
        if not return_logits:
            return ids, None
        return ids, np.concatenate(all_logits, axis=1)

    def generate(self, inputs: Dict[str, np.ndarray], **kwargs) -> Tuple[np.ndarray, np.ndarray]:
        kwargs.setdefault("max_new_tokens", kwargs.pop("max_tokens", None) or self.max_new_tokens)
        return self.greedy_generate(inputs, **kwargs)

    def generator_generate(self, instructions: List[str], inputs: List,
                           current_generated_texts: Optional[List[str]] = None,
                           **kwargs) -> Tuple[np.ndarray, np.ndarray]:
        """Render chat prompts (optionally with forced prefixes) and generate.

        Mirrors `generator/generator.py:271-302`: ``current_generated_texts``
        forces each row to continue after "<prefix>". The prefix rides as a
        TOKEN-level splice (:meth:`tokenizer_encode_with_prefixes`) so the
        conditioning stream is bit-identical to the reference's
        `append_texts_to_decoder_only_generator_inputs` across tokenizer
        merge boundaries.
        """
        assert len(instructions) == len(inputs)
        prompts = [self.render_prompt(inst, inp) for inst, inp in zip(instructions, inputs)]
        if current_generated_texts is not None:
            assert len(current_generated_texts) == len(instructions)
            enc = self.tokenizer_encode_with_prefixes(
                prompts, current_generated_texts,
                max_length=kwargs.pop("max_length", None))
        else:
            enc = self.tokenizer_encode(prompts, max_length=kwargs.pop("max_length", None))
        return self.generate(enc, **kwargs)

    def generate_texts(self, instructions: List[str], inputs: List,
                       stop_words: Optional[Sequence[str]] = None,
                       **kwargs) -> List[str]:
        # text-only consumers never need the [B, G, V] logits buffer
        kwargs.setdefault("return_logits", False)
        ids, _ = self.generator_generate(instructions, inputs, stop_words=stop_words, **kwargs)
        texts = self.tokenizer.batch_decode(ids, skip_special_tokens=True)
        if stop_words:
            texts = [self._trim_at_stop_words(t, stop_words)[0] for t in texts]
        return texts
