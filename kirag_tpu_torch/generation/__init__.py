from kirag_tpu_torch.generation.answer import AnswerGenerator
from kirag_tpu_torch.generation.chat import CHAT_FAMILIES, render_chat
from kirag_tpu_torch.generation.interface import GenerationOutput, Generator
from kirag_tpu_torch.generation.stub import StubBackend, make_stub_generator

__all__ = [
    "GenerationOutput",
    "Generator",
    "render_chat",
    "CHAT_FAMILIES",
    "StubBackend",
    "make_stub_generator",
    "AnswerGenerator",
]
