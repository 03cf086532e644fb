"""QA reader: answer generation over retrieved contexts (port of
:mod:`kirag_tpu.generation.answer`).

Mirrors the reference `AnswerGenerator` (`generator/generator.py:305-417`):
the same task instructions, "The answer is:" prompting, and "answer is"
output parsing, over any Generator backend.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

from kirag_tpu_torch.generation.interface import Generator


class AnswerGenerator(Generator):
    TASK_INSTRUCTION_WO_CONTEXT = "Given a question, please only output the answer to the question."
    TASK_INSTRUCTION_WITH_CONTEXT = "Given some context and a question, please only output the answer to the question."
    TASK_INSTRUCTION_COT = ("Answer the following question by reasoning step-by-step. "
                            "After reasoning, you MUST use \"So the answer is:\" to output the answer.")

    def __init__(self, tokenizer, backend, max_length: int = 4096, max_new_tokens: int = 32,
                 batch_size: int = 4, task_instruction: Optional[str] = None,
                 use_cot: bool = False, **kwargs):
        super().__init__(tokenizer, backend, max_length=max_length,
                         max_new_tokens=max_new_tokens, batch_size=batch_size, **kwargs)
        self.task_instruction = task_instruction
        self.use_cot = use_cot
        self.answer_prefix = "Thought:" if use_cot else "The answer is:"

    def get_generator_inputs(self, questions: List[str],
                             contexts: Optional[List[List[str]]] = None,
                             task_instructions: Optional[Union[str, List[str]]] = None
                             ) -> Tuple[List[str], List[str]]:
        if task_instructions is None:
            if self.task_instruction is not None:
                task_instructions = [self.task_instruction] * len(questions)
            else:
                inst = (self.TASK_INSTRUCTION_COT if self.use_cot else
                        (self.TASK_INSTRUCTION_WO_CONTEXT if contexts is None
                         else self.TASK_INSTRUCTION_WITH_CONTEXT))
                task_instructions = [inst] * len(questions)
        elif isinstance(task_instructions, str):
            task_instructions = [task_instructions] * len(questions)

        user_inputs = []
        for i, question in enumerate(questions):
            user_input = ""
            if contexts is not None:
                context_text = "\n\n".join(
                    f"{j + 1}. {text}" for j, text in enumerate(contexts[i]))
                user_input += f"context:\n\n{context_text}\n\n"
            user_input += f"question: {question}\n{self.answer_prefix}"
            user_inputs.append(user_input)
        return task_instructions, user_inputs

    @staticmethod
    def parse_generated_answers(texts: List[str]) -> List[str]:
        """First non-empty line; strip everything through "answer is[:]"
        (reference `generator/generator.py:348-364`)."""

        def parse(answer: str) -> str:
            lines = answer.split("\n")
            out = ""
            i = 0
            while len(out) < 1 and i < len(lines):
                out = lines[i].strip()
                i += 1
            if "answer is" in out:
                out = out[out.find("answer is") + len("answer is"):].strip()
                if out.startswith(":"):
                    out = out[1:].strip()
            return out

        return [parse(t) for t in texts]

    def batch_generate_answers(self, questions: List[str],
                               contexts: Optional[List[List[str]]] = None,
                               task_instructions=None, **kwargs) -> List[str]:
        if contexts is not None:
            assert len(questions) == len(contexts)
        instructions, user_inputs = self.get_generator_inputs(
            questions, contexts, task_instructions)
        kwargs.setdefault("return_logits", False)  # reader only parses text
        ids, _ = self.generator_generate(instructions, user_inputs, **kwargs)
        texts = self.tokenizer.batch_decode(ids, skip_special_tokens=True)
        return self.parse_generated_answers(texts)

    def generate_answer(self, question: Union[str, List[str]],
                        context=None, task_instruction=None, **kwargs):
        single = isinstance(question, str)
        if single:
            question = [question]
            context = [context] if context is not None else None
        answers = self.batch_generate_answers(question, context, task_instruction, **kwargs)
        return answers[0] if single else answers
