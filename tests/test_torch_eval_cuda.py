"""The evaluation pipeline's card checks (chip_smoke.py phase 16) at a small
size: the int8 KV cache, ``cli/construct_kg_corpus``, ``cli/qa_eval`` and
the ``TripleSelector``'s option step, with a 2-layer NF4 Llama (hidden 512,
Llama-3's vocabulary) whose decode projections run K6.

This file imports neither JAX nor ``kirag_tpu``, so the GPU machine, which
has neither, runs it: ``python -m pytest --noconftest
tests/test_torch_eval_cuda.py -m cuda``. Every test needs the card and skips
without one.
"""

import dataclasses
import importlib.util
import json
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from kirag_tpu_torch.kernels import launch_counts, reset_launch_counts
from kirag_tpu_torch.models import llm

LOGIT_TOL = 2.0 ** -3  # chip_smoke.py's bf16 tolerance, a share of the largest logit


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def nf4_pair(device):
    config = llm.LlamaConfig(hidden_size=512, num_hidden_layers=2, num_attention_heads=8,
                             num_key_value_heads=2, intermediate_size=1024, int4_impl="kernel")
    params = llm.init_llama_params(config, seed=0, device=device, dtype=torch.bfloat16,
                                   quant_bits=4)
    return params, config


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_quantize_on_the_card_is_the_cpus(cuda_device, dtype):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 300, 8, 128, generator=g) * torch.rand(4, 300, 8, 1, generator=g) * 5
    x[0, 3] = 0
    s = torch.tensor(0.37)
    x[1, 2, 0] = (torch.arange(128) - 63.5) * s
    x[1, 2, 0, 0] = 127 * s
    x = x.to(dtype)
    q, scale = llm._kv_quantize(x.to(cuda_device))
    q_cpu, scale_cpu = llm._kv_quantize(x)
    assert torch.equal(q.cpu(), q_cpu) and torch.equal(scale.cpu(), scale_cpu)
    assert not q_cpu[0, 3].any() and not scale_cpu[0, 3].any()


@pytest.mark.cuda
def test_int8_cache_decode_on_the_card(cuda_device, smoke):
    """16 decode steps with the int8 cache against the bf16 cache: the
    prefill's and the first step's logits within LOGIT_TOL of the largest, ids
    equal up to each row's first near-tie, K6 on every projection of a step,
    the cache (hd + 4) / 2 hd of the bf16 bytes."""
    params, config = nf4_pair(cuda_device)
    ids, mask = smoke.left_padded_prompts((300, 120, 40, 9), config.vocab_size, 0)
    runs = {}
    for bits in (None, 8):
        backend = llm.TorchLlamaBackend(params, dataclasses.replace(config, kv_quant_bits=bits),
                                        eos_token_id=smoke.EOS_ID)
        reset_launch_counts()
        out_ids, logits = backend.greedy(ids, mask, 17)
        k6 = launch_counts()["int4_matmul"]
        _, _, state = backend.greedy_start(ids, mask, 17, return_logits=False)
        runs[bits] = (out_ids, logits, k6, smoke.kv_cache_bytes(state))
    (ref_ids, ref_logits, ref_k6, ref_bytes), (got_ids, got_logits, k6, got_bytes) = (
        runs[None], runs[8])
    assert k6 == ref_k6 == (7 * 2 + 1) * 16
    tol = LOGIT_TOL * float(np.abs(ref_logits[:, 1]).max())
    assert float(np.abs(got_logits[:, :2] - ref_logits[:, :2]).max()) <= tol
    smoke.near_tie_agreement(got_ids, ref_ids, ref_logits, tol, "int8 cache")
    hd = config.head_dim  # int8 codes and an f32 scale a (slot, head) against bf16
    assert abs(got_bytes / ref_bytes - (hd + 4) / (2 * hd)) < 1e-6


def byte_corpus(tmp_path, n=6):
    docs = [{"id": f"doc{i}", "title": f"title {i}", "sentences": [
        f"Item {i} is a place in the north.", f"It was named after {i + 100}."]}
        for i in range(n)]
    path = tmp_path / "corpus.json"
    path.write_text(json.dumps(docs))
    return str(path), docs


@pytest.mark.cuda
def test_construct_kg_corpus_on_the_card(cuda_device, smoke, tmp_path):
    from kirag_tpu_torch.cli import construct_kg_corpus

    corpus_path, docs = byte_corpus(tmp_path)
    cache = tmp_path / "kg.pkl"
    reset_launch_counts()
    path = construct_kg_corpus.main(
        ["--corpus", "hotpotqa", "--corpus_path", corpus_path, "--llm", "Llama-3-instruct",
         "--cached_kg_triples_file", str(cache), "--batch_size", "2", "--save_every", "1",
         "--start", "1", "--end", "5"],
        llm_tokenizer=smoke.ByteLevelTokenizer(), llm=nf4_pair(cuda_device))
    assert launch_counts()["int4_matmul"] > 0
    with open(path, "rb") as f:
        assert sorted(pickle.load(f)) == [d["id"] for d in docs[1:5]]


@pytest.mark.cuda
def test_qa_eval_on_the_card(cuda_device, smoke, tmp_path, capsys):
    """A prediction for every question, EM and F1 printed, K6 launched; the
    reader's ids through K6 equal to those through int4_impl="parity" up to
    each row's first near-tie."""
    from kirag_tpu_torch.cli import qa_eval

    data = [{"question": f"What is item {i}?", "answers": [f"place {i}"],
             "ctxs": [{"title": f"title {i}", "text": f"Item {i} is a place."},
                      {"sentences": ["Other text.", "More."]}]} for i in range(3)]
    save_file = tmp_path / "results.json"
    save_file.write_text(json.dumps(data))
    pair = nf4_pair(cuda_device)
    argv = ["--save_file", str(save_file), "--reader", "Llama-3-instruct", "--k", "2"]
    reset_launch_counts()
    em, f1 = qa_eval.main(argv, llm_tokenizer=smoke.ByteLevelTokenizer(), llm=pair)
    assert launch_counts()["int4_matmul"] > 0
    report = capsys.readouterr().out
    assert f">>>> EM: {em:.5f}" in report and f">>>> F1: {f1:.5f}" in report
    args = qa_eval.setup_parser(argv)
    out = {}
    for impl in ("kernel", "parity"):
        reader = qa_eval.build_reader(args, smoke.ByteLevelTokenizer(),
                                      (pair[0], dataclasses.replace(pair[1], int4_impl=impl)))
        out[impl] = reader.generator_generate(*reader.get_generator_inputs(
            [d["question"] for d in data], [["x", "y"]] * len(data)))
        if impl == "kernel":
            em2, f12, preds = qa_eval.evaluate(data, reader, 2, 4)
            assert len(preds) == len(data) and (em2, f12) == (em, f1)
    (k6_ids, _), (plain_ids, plain_logits) = out["kernel"], out["parity"]
    smoke.near_tie_agreement(k6_ids, plain_ids, plain_logits,
                             LOGIT_TOL * float(np.abs(plain_logits).max()), "reader")


@pytest.mark.cuda
def test_option_probs_over_card_logits(cuda_device, smoke):
    """The TripleSelector's option step over logits the card's NF4 decode
    made, with digit tokens forced into some rows: a row that holds an
    option token sums to 1 within 1e-6, every other row is NaN."""
    from kirag_tpu_torch.generation import Generator
    from kirag_tpu_torch.pipeline import TripleSelector

    tok = smoke.ByteLevelTokenizer()
    params, config = nf4_pair(cuda_device)
    backend = llm.TorchLlamaBackend(params, config, eos_token_id=smoke.EOS_ID)
    constructor = Generator(tok, backend, model_name="Llama-3-instruct", max_new_tokens=8)
    selector = TripleSelector(retriever=None, kg_generator=None, constructor=constructor,
                              aligner=None, adaptive_examplars=False)
    reset_launch_counts()
    ids, logits = constructor.generator_generate(["Pick one."] * 3, ["a", "b", "c"])
    assert launch_counts()["int4_matmul"] > 0
    ids = np.array(ids)
    ids[0, 2] = tok.encode("1", add_special_tokens=False)[0]
    ids[1, 0] = tok.encode("0", add_special_tokens=False)[0]
    ids[2] = tok.encode("x" * ids.shape[1], add_special_tokens=False)
    options, probs = selector.get_option_tokens_probs(ids, logits, 4)
    assert options == ["0", "1", "2", "3"]
    np.testing.assert_allclose(probs[:2].astype(np.float64).sum(axis=1), 1.0, atol=1e-6)
    assert np.isnan(probs[2]).all()
