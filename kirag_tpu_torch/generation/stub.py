"""Deterministic fake LLM backend for tests and pipeline development (port of
:mod:`kirag_tpu.generation.stub`).

The reference has no test harness at all (SURVEY.md §4); the KiRAG loop's only
dependency on the LLM is the narrow Generator contract (token ids + logits),
so a rule-based stub makes the full pipeline testable offline: each rule maps
a prompt substring (or a callable) to a response text. The stub tokenizes the
response and fabricates consistent greedy logits (the chosen token gets the
max logit), so logits-consuming code paths (e.g. the TripleSelector's
option-probability beam) exercise realistically.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

Rule = Tuple[Union[str, Callable[[str], bool]], Union[str, Callable[[str], str]]]


class StubBackend:
    def __init__(self, tokenizer, rules: Optional[Sequence[Rule]] = None,
                 default_response: str = "", vocab_size: Optional[int] = None):
        self.tokenizer = tokenizer
        self.rules: List[Rule] = list(rules or [])
        self.default_response = default_response
        self.vocab_size = vocab_size or tokenizer.vocab_size
        self.eos_token_id = tokenizer.eos_token_id if tokenizer.eos_token_id is not None else 0
        self.calls: List[List[str]] = []  # recorded prompts, for assertions

    def add_rule(self, matcher: Union[str, Callable[[str], bool]],
                 response: Union[str, Callable[[str], str]]) -> None:
        self.rules.append((matcher, response))

    def respond(self, prompt: str) -> str:
        for matcher, response in self.rules:
            hit = matcher(prompt) if callable(matcher) else (matcher in prompt)
            if hit:
                return response(prompt) if callable(response) else response
        return self.default_response

    def greedy(self, input_ids: np.ndarray, attention_mask: np.ndarray,
               max_new_tokens: int, return_logits: bool = True
               ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        prompts = [
            self.tokenizer.decode(row[mask.astype(bool)], skip_special_tokens=True)
            for row, mask in zip(input_ids, attention_mask)
        ]
        self.calls.append(prompts)
        responses = [self.respond(p) for p in prompts]
        token_rows = [
            self.tokenizer(r, add_special_tokens=False)["input_ids"][:max_new_tokens]
            for r in responses
        ]
        width = min(max(len(t) + 1 for t in token_rows), max_new_tokens)  # +1 for eos
        b = len(token_rows)
        ids = np.full((b, width), self.eos_token_id, dtype=np.int32)
        logits = np.zeros((b, width, self.vocab_size), dtype=np.float32)
        for i, toks in enumerate(token_rows):
            ids[i, : len(toks)] = toks
            # greedy-consistent logits: argmax(logits[t]) == emitted token
            logits[i, np.arange(width), ids[i]] = 10.0
        return ids, (logits if return_logits else None)


def make_stub_generator(tokenizer, rules: Optional[Sequence[Rule]] = None,
                        default_response: str = "", **generator_kwargs):
    """Convenience: a Generator wired to a StubBackend ('generic' chat family)."""
    from kirag_tpu_torch.generation.interface import Generator

    backend = StubBackend(tokenizer, rules, default_response)
    generator_kwargs.setdefault("model_name", "stub-instruct")
    generator_kwargs.setdefault("max_length", 2048)
    gen = Generator(tokenizer, backend, **generator_kwargs)
    gen.family = "generic"
    return gen
