"""Chat-prompt rendering for the supported LLM families (port of
:mod:`kirag_tpu.generation.chat`).

The reference builds chat messages per model family then defers to HF's
``tokenizer.apply_chat_template`` (`generator/generator.py:90-147`). Since
this framework must run without remote tokenizer configs, the templates are
implemented here directly; when an HF tokenizer with a chat template is
available it can be used instead (see ``Generator.render_prompt``).

Family semantics mirror `generator/generator.py:108-139`:
- llama3 / qwen2: system role supported;
- mistral / gemma2: no system role — the instruction is prepended to the
  first user message.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

Message = Dict[str, str]


def build_messages(family: str, instruction: str,
                   content: Union[str, List[Message]]) -> List[Dict[str, str]]:
    """Normalize (instruction, user content) into role/content messages."""
    has_system = family in ("llama3", "llama2", "qwen2", "generic")
    messages: List[Dict[str, str]] = []
    if has_system:
        messages.append({"role": "system", "content": instruction})
        if isinstance(content, str):
            messages.append({"role": "user", "content": content})
        else:
            assert "user" in content[0], "the first message must come from the user"
            for m in content:
                if "user" in m:
                    messages.append({"role": "user", "content": m["user"]})
                if "assistant" in m:
                    messages.append({"role": "assistant", "content": m["assistant"]})
    else:
        if isinstance(content, str):
            messages.append({"role": "user", "content": instruction + "\n\n" + content})
        else:
            assert "user" in content[0], "the first message must come from the user"
            messages.append({"role": "user", "content": instruction + "\n\n" + content[0]["user"]})
            for m in content[1:]:
                if "user" in m:
                    messages.append({"role": "user", "content": m["user"]})
                if "assistant" in m:
                    messages.append({"role": "assistant", "content": m["assistant"]})
    return messages


def _render_llama3(messages: List[Dict[str, str]], add_generation_prompt: bool) -> str:
    out = ["<|begin_of_text|>"]
    for m in messages:
        out.append(f"<|start_header_id|>{m['role']}<|end_header_id|>\n\n{m['content']}<|eot_id|>")
    if add_generation_prompt:
        out.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
    return "".join(out)


def _render_qwen2(messages: List[Dict[str, str]], add_generation_prompt: bool) -> str:
    out = []
    for m in messages:
        out.append(f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n")
    if add_generation_prompt:
        out.append("<|im_start|>assistant\n")
    return "".join(out)


def _render_llama2(messages: List[Dict[str, str]], add_generation_prompt: bool) -> str:
    """Llama-2-chat format: [INST] <<SYS>>...<</SYS>> user [/INST] answer </s>."""
    out = []
    system = ""
    for m in messages:
        if m["role"] == "system":
            system = f"<<SYS>>\n{m['content']}\n<</SYS>>\n\n"
        elif m["role"] == "user":
            out.append(f"<s>[INST] {system}{m['content']} [/INST]")
            system = ""
        elif m["role"] == "assistant":
            out.append(f" {m['content']} </s>")
    return "".join(out)


def _render_mistral(messages: List[Dict[str, str]], add_generation_prompt: bool) -> str:
    out = ["<s>"]
    for m in messages:
        if m["role"] == "user":
            out.append(f"[INST] {m['content']} [/INST]")
        elif m["role"] == "assistant":
            out.append(f"{m['content']}</s>")
    return "".join(out)


def _render_gemma2(messages: List[Dict[str, str]], add_generation_prompt: bool) -> str:
    out = ["<bos>"]
    for m in messages:
        role = "model" if m["role"] == "assistant" else "user"
        out.append(f"<start_of_turn>{role}\n{m['content']}<end_of_turn>\n")
    if add_generation_prompt:
        out.append("<start_of_turn>model\n")
    return "".join(out)


def _render_generic(messages: List[Dict[str, str]], add_generation_prompt: bool) -> str:
    """Plain-text template used by the stub backend and base (non-chat) LMs."""
    out = [f"{m['role']}: {m['content']}\n" for m in messages]
    if add_generation_prompt:
        out.append("assistant: ")
    return "".join(out)


CHAT_FAMILIES = {
    "llama3": _render_llama3,
    "llama2": _render_llama2,
    "qwen2": _render_qwen2,
    "mistral": _render_mistral,
    "gemma2": _render_gemma2,
    "generic": _render_generic,
}


def detect_family(model_name: str) -> str:
    name = model_name.lower()
    if "llama-2" in name or "llama2" in name:
        return "llama2"
    for key in ("llama", "qwen", "mistral", "gemma"):
        if key in name:
            return {"llama": "llama3", "qwen": "qwen2",
                    "mistral": "mistral", "gemma": "gemma2"}[key]
    return "generic"


def detect_is_chat(model_name: str) -> bool:
    """Mirror `generator/generator.py:66-73`."""
    name = model_name.lower()
    return "instruct" in name or "chat" in name or "-it" in name


def render_chat(family: str, messages: List[Dict[str, str]],
                add_generation_prompt: bool = True) -> str:
    if family not in CHAT_FAMILIES:
        raise KeyError(f"chat family {family} not supported; one of {list(CHAT_FAMILIES)}")
    return CHAT_FAMILIES[family](messages, add_generation_prompt)
