"""Functions the port lacked, held against the JAX package:
``DenseRetriever.compute_logits`` and ``score``, ``utils/io.load_tsv`` and
``save_tsv``, and ``models/registry.load_llm`` (an injected tokenizer; its
greedy ids are the ``cli/retrieve`` loader's, which shares its loader).
"""

import numpy as np
import pytest
import torch

from kirag_tpu.models import registry as jax_registry
from kirag_tpu.retrieval import DenseRetriever as JaxDenseRetriever
from kirag_tpu.utils import io as jax_io
from kirag_tpu_torch.models import registry
from kirag_tpu_torch.retrieval import DenseRetriever
from kirag_tpu_torch.utils import io

from tests.helpers import BASE_VOCAB, WORDS

SHAPES = {"d x d": ((16,), (16,), ()), "d x m,d": ((16,), (5, 16), (5,)),
          "n,d x n,m,d": ((3, 16), (3, 5, 16), (3, 5)), "n,d x m,d": ((3, 16), (7, 16), (3, 7))}


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_compute_logits_matches_the_reference(rng, case):
    q_shape, d_shape, out_shape = SHAPES[case]
    q = rng.randn(*q_shape).astype(np.float32)
    d = rng.randn(*d_shape).astype(np.float32)
    got = DenseRetriever.compute_logits(q, d)
    want = JaxDenseRetriever.compute_logits(q, d)
    assert np.shape(got) == np.shape(want) == out_shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(DenseRetriever.compute_logits(torch.from_numpy(q),
                                                                torch.from_numpy(d)), want)


def test_compute_logits_refuses_other_shapes(rng):
    with pytest.raises(ValueError, match="Invalid embedding shapes"):
        DenseRetriever.compute_logits(rng.randn(2, 3, 4), rng.randn(4))
    with pytest.raises(ValueError, match="queries for"):
        DenseRetriever.compute_logits(rng.randn(2, 4), rng.randn(3, 5, 4))


@pytest.mark.parametrize("temperature", [1.0, 0.05, "sqrt"])
@pytest.mark.parametrize("case", ["d x m,d", "n,d x m,d"])
def test_score_matches_the_reference(rng, temperature, case):
    q_shape, d_shape, _ = SHAPES[case]
    q = rng.randn(*q_shape).astype(np.float32)
    d = rng.randn(*d_shape).astype(np.float32)
    port = DenseRetriever(None, None, temperature=temperature)
    ref = JaxDenseRetriever(None, None, temperature=temperature)
    np.testing.assert_array_equal(port.score(q, d), ref.score(q, d))
    if temperature == "sqrt":
        np.testing.assert_allclose(port.score(q, d), port.compute_logits(q, d) / 4.0)


ROWS = [("q1", "Who wrote it?", 3, 0.5), ("q2", "", -1, 1.0 / 3.0),
        ("q3", "tab-free text, \"quoted\"", 0, 2.5e-7), ("q4", "ünï", 10 ** 12, -123.4567891)]


def test_save_tsv_writes_the_references_bytes(tmp_path):
    port_path, ref_path = tmp_path / "port.tsv", tmp_path / "ref.tsv"
    assert io.save_tsv(ROWS, str(port_path)) == str(port_path)
    jax_io.save_tsv(ROWS, str(ref_path))
    assert port_path.read_bytes() == ref_path.read_bytes()
    assert "0.333333" in port_path.read_text(encoding="utf-8")  # floats as %.6f


def test_load_tsv_round_trips_and_matches_the_reference(tmp_path):
    path = tmp_path / "rows.tsv"
    jax_io.save_tsv(ROWS, str(path))
    got = io.load_tsv(str(path))
    assert got == jax_io.load_tsv(str(path))
    assert got[0] == ("q1", "Who wrote it?", "3", "0.500000")
    assert all(isinstance(row, tuple) and len(row) == 4 for row in got)
    raw = tmp_path / "raw.tsv"  # empty fields, a last line without newline
    raw.write_text("a\t\tb\n\nc\td", encoding="utf-8")
    assert io.load_tsv(str(raw)) == jax_io.load_tsv(str(raw)) == [
        ("a", "", "b"), ("",), ("c", "d")]


@pytest.fixture(scope="module")
def tiny_llama(tmp_path_factory):
    """A seeded 2-layer HF Llama checkpoint and a word-level tokenizer."""
    import transformers

    root = tmp_path_factory.mktemp("registry_llm")
    (root / "vocab.txt").write_text("\n".join(BASE_VOCAB + WORDS))
    tok = transformers.BertTokenizerFast(vocab_file=str(root / "vocab.txt"), do_lower_case=True)
    torch.manual_seed(3)
    model = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=tok.vocab_size, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, intermediate_size=128, max_position_embeddings=256))
    llm_dir = root / "llama-tiny-instruct"
    model.save_pretrained(str(llm_dir))
    tok.save_pretrained(str(llm_dir))
    return str(llm_dir), tok


def prompt_ids(tok):
    batch = tok(["w1 w2 w3 w4", "w5 w6"], padding=True, return_tensors="np")
    ids, mask = batch["input_ids"].astype(np.int32), batch["attention_mask"].astype(np.int32)
    # left padding, as the Generator pads its prompts
    order = np.argsort(mask, axis=1, kind="stable")
    return np.take_along_axis(ids, order, 1), np.take_along_axis(mask, order, 1)


@pytest.mark.parametrize("quant_bits", [None, 4])
def test_load_llm_decodes_as_the_retrieve_cli_loader(tiny_llama, quant_bits):
    from kirag_tpu_torch.cli import retrieve

    path, tok = tiny_llama
    tokenizer, generator = registry.load_llm(path, tokenizer=tok, max_new_tokens=8,
                                             quant_bits=quant_bits, device="cpu")
    assert tokenizer is tok and generator.tokenizer is tok
    assert generator.backend.eos_token_id == tok.eos_token_id
    argv = ["--dataset", "d", "--query_file", "q", "--index_folder", "i", "--llm", path,
            "--aligner_model_name_or_path", "a", "--save_file", "s",
            "--retriever_model_name_or_path", "r"]
    if quant_bits:
        argv += ["--llm_quant_bits", str(quant_bits)]
    constructor, _ = retrieve.setup_llm_generator(retrieve.setup_parser(argv),
                                                  llm_tokenizer=tok, device="cpu")
    ids, mask = prompt_ids(tok)
    got, got_lg = generator.backend.greedy(ids, mask, 8)
    want, want_lg = constructor.backend.greedy(ids, mask, 8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_lg, want_lg)
    assert len(set(got[0].tolist())) > 1  # seeded weights: not one repeated token
    for name, value in generator.backend.params["layers"][0].items():
        other = constructor.backend.params["layers"][0][name]
        assert type(value) is type(other)


def test_load_llm_settings_are_the_references(tiny_llama):
    path, tok = tiny_llama
    _, port = registry.load_llm(path, tokenizer=tok, max_length=512, max_new_tokens=16,
                                batch_size=2, device="cpu")
    _, ref = jax_registry.load_llm(path, max_length=512, max_new_tokens=16, batch_size=2)
    for field in ("model_name", "max_length", "max_new_tokens", "batch_size", "family",
                  "is_chat"):
        assert getattr(port, field) == getattr(ref, field), field
    assert registry.MODEL_MAP == jax_registry.MODEL_MAP


def test_load_llm_resolves_aliases_under_the_model_dir(tiny_llama, tmp_path):
    path, tok = tiny_llama
    with pytest.raises(FileNotFoundError, match="no network"):
        registry.load_llm("llama3", tokenizer=tok, model_dir=str(tmp_path), device="cpu")
    (tmp_path / "Meta-Llama-3-8B-Instruct").symlink_to(path)
    _, generator = registry.load_llm("llama3", tokenizer=tok, model_dir=str(tmp_path),
                                     device="cpu")
    assert generator.model_name == "meta-llama/Meta-Llama-3-8B-Instruct"
