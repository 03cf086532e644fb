"""The port's reader (``generation/answer.py``) and ``cli/qa_eval.py`` held
against the JAX package.

- ``AnswerGenerator``'s prompts (the chat-templated strings of every chat
  family and plain text) and its answer parsing, with and without context,
  with and without CoT, are identical;
- its answers over the rule-based stub backend, and over a tiny Llama (2
  layers, hidden 512, a non-zero final norm: real decodes at f32) are
  identical;
- ``qa_eval.evaluate`` gives JAX's EM, F1 and predictions;
- ``qa_eval.main`` with an injected tokenizer and ``(params, config)`` pair
  prints JAX's report on a zero-norm checkpoint (both CLIs decode in bf16).
"""

import json
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kirag_tpu.cli import qa_eval as jax_qa_eval
from kirag_tpu.generation import AnswerGenerator as JaxAnswerGenerator
from kirag_tpu.generation import StubBackend as JaxStubBackend
from kirag_tpu.models import llm as jax_llm
from kirag_tpu_torch.cli import qa_eval
from kirag_tpu_torch.generation import AnswerGenerator, StubBackend
from kirag_tpu_torch.models import llm

from tests.helpers import make_tokenizer
from tests.torch_cli_helpers import cli_workspace, torch_threads  # noqa: F401
from tests.test_torch_llm import jax_params, port_config

PKG = {"jax": (JaxAnswerGenerator, JaxStubBackend), "port": (AnswerGenerator, StubBackend)}
QUESTIONS = ["who is w3 ?", "where was w7 born ?", "what did w12 write ?"]
CONTEXTS = [["w3 is the king of w103 .", "w4 of w104 ."], ["w7 was born in the city w107 ."],
            ["w12 wrote the film w112 .", "w13 is a river .", "w14 died ."]]


def reader_rule(prompt):
    """An answer keyed on the question's first word, in the shapes the
    parser handles: a bare answer, "the answer is:" after text, CoT's "So the
    answer is:", blank first lines."""
    seg = prompt.lower().split("question :")[-1]
    n = int(re.findall(r"w(\d+)", seg)[0])
    return {3: "w103", 7: "\n\n the answer is : w107 city", 12: "w12 wrote it . so the answer "
            "is w112"}.get(n, "i do not know")


def stub_readers(tmp_path, **kwargs):
    tok = make_tokenizer(tmp_path)
    return {name: gen(tok, stub(tok, rules=[(lambda p: "question" in p.lower(), reader_rule)]),
                      **kwargs)
            for name, (gen, stub) in PKG.items()}


@pytest.mark.parametrize("model_name", ["Meta-Llama-3-8B-Instruct", "Llama-2-7b-chat",
                                        "Qwen2-7B-Instruct", "Mistral-7B-Instruct",
                                        "gemma-2-9b-it", "llama-base"])
@pytest.mark.parametrize("use_cot", [False, True])
def test_prompts_and_parses_match_jax(tmp_path, model_name, use_cot):
    readers = stub_readers(tmp_path, model_name=model_name, use_cot=use_cot)
    outs = {}
    for name, reader in readers.items():
        calls = []
        for contexts in (None, CONTEXTS):
            for inst in (None, "Answer briefly.", ["a", "b", "c"]):
                inputs = reader.get_generator_inputs(QUESTIONS, contexts, inst)
                calls.append((inputs, reader.prompt(*inputs), reader.answer_prefix))
        outs[name] = calls
    assert outs["port"] == outs["jax"]
    texts = ["w103", "\n\n  The answer is: w107\nmore", "so the answer is w112", "answer is:",
             "", "x\ny", "Thought: w1 . So the answer is: w9 ."]
    assert (AnswerGenerator.parse_generated_answers(texts)
            == JaxAnswerGenerator.parse_generated_answers(texts))
    custom = stub_readers(tmp_path, model_name=model_name, task_instruction="Custom.")
    assert (custom["port"].get_generator_inputs(QUESTIONS, CONTEXTS)
            == custom["jax"].get_generator_inputs(QUESTIONS, CONTEXTS))


@pytest.mark.parametrize("use_cot", [False, True])
def test_answers_over_stub_match_jax(tmp_path, use_cot):
    readers = stub_readers(tmp_path, model_name="stub-instruct", use_cot=use_cot)
    outs = {}
    for name, reader in readers.items():
        reader.family = "generic"
        outs[name] = (reader.generate_answer(QUESTIONS, context=CONTEXTS),
                      reader.generate_answer(QUESTIONS),
                      reader.generate_answer(QUESTIONS[1], context=CONTEXTS[1]),
                      reader.backend.calls)
    assert outs["port"] == outs["jax"]
    assert outs["port"][0] == ["w103", "w107 city", "w112"]


def test_answers_over_a_tiny_llama_match_jax(tmp_path):
    """Real greedy decodes at f32: the same parameters (a non-zero final norm)
    in both packages, the same prompts; the answers' texts are identical."""
    tok = make_tokenizer(tmp_path)
    config, tree = jax_params("llama", "f32")
    backends = {
        "jax": jax_llm.JaxLlamaBackend(jax.tree.map(jnp.asarray, tree), config,
                                       eos_token_id=tok.sep_token_id,
                                       compute_dtype=jnp.float32, prompt_buckets=(64, 128)),
        "port": llm.TorchLlamaBackend(llm.llama_params_from_jax(tree, device="cpu"),
                                      port_config(config), eos_token_id=tok.sep_token_id,
                                      compute_dtype=torch.float32, prompt_buckets=(64, 128))}
    outs = {}
    for name, backend in backends.items():
        reader = PKG[name][0](tok, backend, model_name="tiny-llama-instruct", max_new_tokens=12,
                              batch_size=2)
        reader.family = "generic"
        with torch_threads(1):
            ids, _ = reader.generator_generate(*reader.get_generator_inputs(QUESTIONS[:2],
                                                                            CONTEXTS[:2]))
            outs[name] = (ids, reader.generate_answer(QUESTIONS[:2], context=CONTEXTS[:2]),
                          reader.generate_answer(QUESTIONS[2]))
    np.testing.assert_array_equal(outs["port"][0], outs["jax"][0])
    assert outs["port"][1:] == outs["jax"][1:]
    assert any(outs["port"][1])  # the random model said something


def qa_data():
    return [
        {"question": QUESTIONS[0], "answers": ["w103", "w3"],
         "ctxs": [{"title": "w3", "text": CONTEXTS[0][0]}, {"title": "w4", "text": "x ."}]},
        {"question": QUESTIONS[1], "answers": "w107",
         "ctxs": [{"title": "w7", "sentences": ["w7 was born", "in w107 ."]}]},
        {"question": QUESTIONS[2], "answers": ["the film w112"],
         "ctxs": [{"text": CONTEXTS[2][0]}, {"sentences": ["w13 ."]}, {"text": "w14 ."}]},
        {"question": "what is w20 ?", "answers": ["w120"], "ctxs": []},
    ]


@pytest.mark.parametrize("k,batch_size", [(2, 3), (0, 4), (5, 1)])
def test_qa_eval_evaluate_matches_jax(tmp_path, k, batch_size):
    readers = stub_readers(tmp_path, model_name="stub-instruct")
    outs = {}
    for name, evaluate in (("jax", jax_qa_eval.evaluate), ("port", qa_eval.evaluate)):
        readers[name].family = "generic"
        outs[name] = (evaluate(qa_data(), readers[name], k, batch_size),
                      readers[name].backend.calls)
    assert outs["port"] == outs["jax"]
    em, f1, preds = outs["port"][0]
    assert len(preds) == 4 and 0 < em < 1 and 0 < f1 < 1


def test_qa_eval_cli_matches_jax(cli_workspace, monkeypatch, capsys):
    """Both CLIs over one results file and the zero-norm checkpoint: the same
    report; the port's reader injected (tokenizer and a bf16 pair)."""
    import transformers

    ws = cli_workspace
    save_file = ws["root"] / "qa_results.json"
    save_file.write_text(json.dumps(qa_data()))
    argv = ["--save_file", str(save_file), "--reader", ws["llm_dir"], "--k", "2",
            "--batch_size", "2"]
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    jax_qa_eval.main()
    want = capsys.readouterr().out
    tok = transformers.AutoTokenizer.from_pretrained(ws["llm_dir"])
    pair = llm.load_llama(ws["llm_dir"], compute_dtype=torch.bfloat16, device="cpu")
    with torch_threads(1):
        em_f1 = qa_eval.main(argv, llm_tokenizer=tok, llm=pair, device="cpu")
        got = capsys.readouterr().out
        assert qa_eval.main(argv, device="cpu") == em_f1  # the reader read from --reader
    assert got == want and ">>>> EM: " in got
    assert f"{em_f1[0]:.5f}" in got and f"{em_f1[1]:.5f}" in got
    capsys.readouterr()
    if not torch.cuda.is_available():  # without device="cpu" the CLI runs on the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            qa_eval.main(argv, llm_tokenizer=tok, llm=pair)
