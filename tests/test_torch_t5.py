"""The port's T5 reader backend (``kirag_tpu_torch/models/t5.py``) held
against the JAX package's ``kirag_tpu/models/t5.py`` on the CPU.

Tiny seeded models (vocab 96, d_model 32, d_kv 8, 4 heads, 2 + 2 layers, 8
buckets up to distance 16), ``relu`` and ``gated-gelu``, tied and untied,
take the same numpy weights and inputs in both packages:

- the relative-position buckets bitwise over -2048..2048, both directions;
- at float32: encoder hidden states within 1e-5, ``t5_decode_step`` logits
  within 1e-5 of the largest, ``t5_greedy_decode`` ids equal and logits
  within 1e-4 of the largest (without eos, with it, with a row that
  finishes early);
- at bf16 compute: ids equal up to each row's first near-tie, logits
  within 2^-3 of the largest;
- ``load_t5`` of a checkpoint ``transformers`` saves (safetensors and bin)
  gives JAX's tree, dtypes included;
- ``TorchT5Backend`` against ``JaxT5Backend`` through ``Generator`` and
  ``AnswerGenerator`` (a prompt padded to a bucket, one truncated).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kirag_tpu.generation import AnswerGenerator as JaxAnswerGenerator
from kirag_tpu.generation.interface import Generator as JaxGenerator
from kirag_tpu.models import t5 as jt5
from kirag_tpu_torch.generation import AnswerGenerator
from kirag_tpu_torch.generation.interface import Generator
from kirag_tpu_torch.models import t5

from tests.helpers import make_tokenizer

LOGIT_TOL_BF16 = 2.0 ** -3
FEED_FORWARD = ("relu", "gated-gelu")
TIED = (True, False)


def hf_config(feed_forward_proj="gated-gelu", tie=False, vocab=96):
    return {"vocab_size": vocab, "d_model": 32, "d_kv": 8, "d_ff": 64, "num_layers": 2,
            "num_decoder_layers": 2, "num_heads": 4, "relative_attention_num_buckets": 8,
            "relative_attention_max_distance": 16, "feed_forward_proj": feed_forward_proj,
            "decoder_start_token_id": 0, "tie_word_embeddings": tie, "layer_norm_epsilon": 1e-6}


def hf_state_dict(cfg: dict, seed: int = 0) -> dict:
    """Seeded numpy weights under HF T5's names, each kernel at HF's init
    scale (unit embeddings, d^-1/2 projections), norms near 1."""
    rng = np.random.RandomState(seed)
    d, inner, ff = cfg["d_model"], cfg["d_kv"] * cfg["num_heads"], cfg["d_ff"]

    def normal(*shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    def norm():
        return (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)

    sd = {"shared.weight": normal(cfg["vocab_size"], d, std=1.0)}
    if not cfg["tie_word_embeddings"]:
        sd["lm_head.weight"] = normal(cfg["vocab_size"], d, std=d ** -0.5)
    gated = cfg["feed_forward_proj"].startswith("gated")
    for stack, n_layers in (("encoder", cfg["num_layers"]), ("decoder", cfg["num_decoder_layers"])):
        for i in range(n_layers):
            p = f"{stack}.block.{i}.layer"
            attns = ["0.SelfAttention"] + (["1.EncDecAttention"] if stack == "decoder" else [])
            for attn in attns:
                for name in "qkv":
                    sd[f"{p}.{attn}.{name}.weight"] = normal(inner, d, std=d ** -0.5)
                sd[f"{p}.{attn}.o.weight"] = normal(d, inner, std=inner ** -0.5)
                sd[f"{p}.{attn.split('.')[0]}.layer_norm.weight"] = norm()
            ffp = f"{p}.{len(attns)}"
            for name in (("wi_0", "wi_1") if gated else ("wi",)):
                sd[f"{ffp}.DenseReluDense.{name}.weight"] = normal(ff, d, std=d ** -0.5)
            sd[f"{ffp}.DenseReluDense.wo.weight"] = normal(d, ff, std=ff ** -0.5)
            sd[f"{ffp}.layer_norm.weight"] = norm()
        sd[f"{stack}.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = normal(
            cfg["relative_attention_num_buckets"], cfg["num_heads"], std=d ** -0.5)
        sd[f"{stack}.final_layer_norm.weight"] = norm()
    return sd


@pytest.fixture(scope="module", params=[(f, tie) for f in FEED_FORWARD for tie in TIED],
                ids=lambda p: f"{p[0]}-{'tied' if p[1] else 'untied'}")
def pair(request):
    """(JAX params, JAX config, port params, port config), float32, CPU."""
    cfg = hf_config(*request.param)
    sd = hf_state_dict(cfg, seed=len(request.param[0]) + request.param[1])
    jconfig, config = jt5.config_from_hf(cfg), t5.config_from_hf(cfg)
    return (jt5.convert_hf_t5_state_dict(sd, jconfig), jconfig,
            t5.convert_hf_t5_state_dict(sd, config), config)


def batch(seed=0, b=3, t=10, vocab=96):
    rng = np.random.RandomState(seed)
    ids = rng.randint(2, vocab, size=(b, t)).astype(np.int32)
    mask = np.ones((b, t), dtype=np.int32)
    mask[0, 7:] = 0  # right padding (encoder convention)
    ids[mask == 0] = 0
    return ids, mask


def to_bf16_jax(params):
    return jax.tree.map(lambda x: x.astype(jnp.bfloat16) if x.ndim >= 2 else x, params)


def assert_logits_close(got, want, rel, what):
    gap = float(np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32)).max())
    scale = float(np.abs(np.asarray(want, np.float32)).max())
    assert gap <= rel * scale, f"{what}: logits differ by {gap} > {rel} x {scale}"


def agree_to_first_near_tie(got_ids, ref_ids, ref_logits, tol):
    """Ids equal up to (not including) each row's first step whose top-2
    margin in the reference is under ``tol``."""
    top2 = np.sort(ref_logits, axis=-1)[..., -2:]
    margins = top2[..., 1] - top2[..., 0]
    for row in range(len(ref_ids)):
        close = np.nonzero(margins[row] < tol)[0]
        upto = int(close[0]) if len(close) else ref_ids.shape[1]
        np.testing.assert_array_equal(got_ids[row, :upto], ref_ids[row, :upto])


# ----------------------------------------------------------------- buckets


@pytest.mark.parametrize("num_buckets,max_distance", [(8, 16), (32, 128), (32, 64)])
@pytest.mark.parametrize("bidirectional", [True, False])
def test_buckets_are_jax_bitwise(num_buckets, max_distance, bidirectional):
    rel = np.arange(-2048, 2049, dtype=np.int32)
    want = np.asarray(jax.jit(lambda r: jt5._relative_position_bucket(
        r, bidirectional, num_buckets, max_distance))(jnp.asarray(rel)))
    got = t5._relative_position_bucket(torch.from_numpy(rel).long(), bidirectional,
                                       num_buckets, max_distance)
    np.testing.assert_array_equal(got.numpy(), want)
    # the bias built from them, the same float32 values for each (query, key)
    cfg = t5.T5Config(relative_attention_num_buckets=num_buckets,
                      relative_attention_max_distance=max_distance, num_heads=3)
    emb = np.random.RandomState(num_buckets).standard_normal((num_buckets, 3)).astype(np.float32)
    q_pos, k_pos = np.arange(40, 200), np.arange(300)
    want_bias = np.asarray(jt5._position_bias(jnp.asarray(emb), jnp.asarray(q_pos),
                                              jnp.asarray(k_pos), bidirectional, cfg))
    got_bias = t5._position_bias(torch.from_numpy(emb), q_pos, k_pos, bidirectional, cfg)
    np.testing.assert_array_equal(got_bias.numpy(), want_bias)


# ----------------------------------------------------------------- float32


def test_encoder_matches_jax(pair):
    jp, jconfig, pp, config = pair
    ids, mask = batch()
    want = np.asarray(jt5.t5_encode(jp, jnp.asarray(ids), jnp.asarray(mask), jconfig))
    got = t5.t5_encode(pp, ids, mask, config).numpy()
    sel = mask.astype(bool)
    np.testing.assert_allclose(got[sel], want[sel], rtol=0, atol=1e-5)
    # left padding: the real tokens' states are the right-padded row's
    left_ids, left_mask = np.roll(ids[:1], 3, axis=1), np.roll(mask[:1], 3, axis=1)
    left = t5.t5_encode(pp, left_ids, left_mask, config).numpy()
    np.testing.assert_allclose(left[0, 3:], got[0, :7], rtol=0, atol=1e-5)


def test_decode_step_matches_jax(pair):
    jp, jconfig, pp, config = pair
    ids, mask = batch(1)
    enc = np.asarray(jt5.t5_encode(jp, jnp.asarray(ids), jnp.asarray(mask), jconfig))
    dec = np.random.RandomState(2).randint(0, 96, size=(3, 6)).astype(np.int32)
    want = np.asarray(jt5.t5_decode_step(jp, jnp.asarray(dec), jnp.asarray(enc),
                                         jnp.asarray(mask), jconfig))
    got = t5.t5_decode_step(pp, dec, torch.from_numpy(enc.copy()), mask, config)
    assert got.dtype == torch.float32 and got.shape == (3, 6, 96)
    assert_logits_close(got.numpy(), want, 1e-5, "t5_decode_step")


@pytest.mark.parametrize("eos", ["none", "eos", "early"])
def test_greedy_matches_jax(pair, eos):
    jp, jconfig, pp, config = pair
    ids, mask = batch(3)
    max_new = 8
    eos_id = None
    if eos != "none":
        free_ids, _ = jt5.t5_greedy_decode(jp, jnp.asarray(ids), jnp.asarray(mask), jconfig,
                                           max_new)
        free_ids = np.asarray(free_ids)
        # "early": the token row 1 emits at step 2, so that row finishes there
        eos_id = int(free_ids[1, 2]) if eos == "early" else 1
    want_ids, want_logits = jt5.t5_greedy_decode(jp, jnp.asarray(ids), jnp.asarray(mask),
                                                 jconfig, max_new, eos_token_id=eos_id)
    got_ids, got_logits = t5.t5_greedy_decode(pp, ids, mask, config, max_new,
                                              eos_token_id=eos_id)
    assert got_ids.dtype == torch.int32 and got_logits.shape == (3, max_new, 96)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    assert_logits_close(got_logits.numpy(), want_logits, 1e-4, "t5_greedy_decode")
    if eos == "early":
        row = got_ids[1].numpy()
        first = int(np.argmax(row == eos_id))
        assert first <= 2 and (row[first:] == eos_id).all()
    _, none_logits = t5.t5_greedy_decode(pp, ids, mask, config, max_new, eos_token_id=eos_id,
                                         return_logits=False)
    assert none_logits is None


# ----------------------------------------------------------------- bf16


def test_greedy_bf16_matches_jax(pair):
    jp, jconfig, pp, config = pair
    ids, mask = batch(4)
    max_new = 8
    want_ids, want_logits = jt5.t5_greedy_decode(
        to_bf16_jax(jp), jnp.asarray(ids), jnp.asarray(mask), jconfig, max_new,
        compute_dtype=jnp.bfloat16)
    bf16 = t5.cast_t5_params(pp, torch.bfloat16)
    got_ids, got_logits = t5.t5_greedy_decode(bf16, ids, mask, config, max_new,
                                              compute_dtype=torch.bfloat16)
    got_ids, got_logits = got_ids.numpy(), got_logits.numpy()
    want_ids, want_logits = np.asarray(want_ids), np.asarray(want_logits)
    tol = LOGIT_TOL_BF16 * float(np.abs(want_logits).max())
    agree_to_first_near_tie(got_ids, want_ids, want_logits, tol)
    # logits from the same decoder inputs: each row's steps up to its first
    # differing id, that step included
    for row in range(len(want_ids)):
        differ = np.nonzero(got_ids[row] != want_ids[row])[0]
        upto = int(differ[0]) + 1 if len(differ) else max_new
        gap = float(np.abs(got_logits[row, :upto] - want_logits[row, :upto]).max())
        assert gap <= tol, f"bf16 greedy, row {row}: logits differ by {gap} > {tol}"


def test_params_from_jax(pair):
    jp, _, pp, config = pair
    tree = jax.tree.map(np.asarray, to_bf16_jax(jp))
    got = t5.t5_params_from_jax(tree, device="cpu")
    leaves, want = jax.tree.leaves(got), jax.tree.leaves(tree)
    assert len(leaves) == len(want)
    for g, w in zip(leaves, want):
        assert str(g.dtype).removeprefix("torch.") == w.dtype.name
        np.testing.assert_array_equal(g.float().numpy(), w.astype(np.float32))
    # the carried tree decodes as the port's own bf16 cast of the same weights
    ids, mask = batch(5)
    got_ids, got_logits = t5.t5_greedy_decode(got, ids, mask, config, 4,
                                              compute_dtype=torch.bfloat16)
    own_ids, own_logits = t5.t5_greedy_decode(t5.cast_t5_params(pp, torch.bfloat16), ids, mask,
                                              config, 4, compute_dtype=torch.bfloat16)
    assert torch.equal(got_ids, own_ids) and torch.equal(got_logits, own_logits)


# ----------------------------------------------------------------- loading


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
@pytest.mark.parametrize("tie", TIED)
def test_load_t5_matches_jax(tmp_path, fmt, tie):
    transformers = pytest.importorskip("transformers")
    cfg = hf_config("gated-gelu", tie)
    model = transformers.T5ForConditionalGeneration(transformers.T5Config(**cfg))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in hf_state_dict(cfg).items()},
                          strict=False)
    model.save_pretrained(tmp_path, safe_serialization=fmt == "safetensors")
    assert (tmp_path / ("model.safetensors" if fmt == "safetensors"
                        else "pytorch_model.bin")).exists()
    want, jconfig = jt5.load_t5(str(tmp_path))
    got, config = t5.load_t5(str(tmp_path), device="cpu")
    assert dataclasses.asdict(config) == dataclasses.asdict(jconfig)
    got_leaves = jax.tree_util.tree_flatten_with_path(got)[0]
    want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        w = np.asarray(w)
        assert str(g.dtype).removeprefix("torch.") == w.dtype.name, path
        assert w.dtype.name == ("bfloat16" if w.ndim >= 2 else "float32"), path
        np.testing.assert_array_equal(g.float().numpy(), w.astype(np.float32), err_msg=str(path))
    with pytest.raises(FileNotFoundError):
        t5.load_t5(str(tmp_path / "missing"), device="cpu")


# ----------------------------------------------------------------- backend


@pytest.fixture(scope="module")
def generator_pair():
    """Both packages' backends over one gated, untied model whose vocab
    is the test tokenizer's 287 ids; buckets 16 and 32."""
    cfg = hf_config("gated-gelu", False, vocab=287)
    sd = hf_state_dict(cfg, seed=7)
    jconfig, config = jt5.config_from_hf(cfg), t5.config_from_hf(cfg)
    return (jt5.convert_hf_t5_state_dict(sd, jconfig), jconfig,
            t5.convert_hf_t5_state_dict(sd, config), config)


def backends(generator_pair, eos):
    jp, jconfig, pp, config = generator_pair
    return {"jax": jt5.JaxT5Backend(jp, jconfig, eos_token_id=eos, compute_dtype=jnp.float32,
                                    prompt_buckets=(16, 32)),
            "port": t5.TorchT5Backend(pp, config, eos_token_id=eos, compute_dtype=torch.float32,
                                      prompt_buckets=(16, 32), device="cpu")}


def test_backend_through_generator_matches_jax(tmp_path, generator_pair):
    tok = make_tokenizer(tmp_path)
    instructions = ["summarize", "answer"]
    short = "alpha beta gamma"                      # padded to the 16 bucket
    long = " ".join(f"w{i}" for i in range(40))     # truncated to the 32 bucket
    outs = {}
    for name, backend in backends(generator_pair, tok.sep_token_id).items():
        gen = (JaxGenerator if name == "jax" else Generator)(
            tok, backend, model_name="t5-tiny", is_chat=False, max_length=64,
            max_new_tokens=6, batch_size=2)
        inputs = gen.tokenizer_encode(gen.prompt(instructions, [short, long]))
        assert inputs["input_ids"].shape[1] > 32  # the long row passes the largest bucket
        one = gen.tokenizer_encode(gen.prompt(instructions[:1], [short]))
        assert one["input_ids"].shape[1] <= 16
        outs[name] = (gen.greedy_generate(inputs), gen.greedy_generate(one),
                      gen.generator_generate(instructions, [short, long]))
    for (got_ids, got_logits), (want_ids, want_logits) in zip(outs["port"][:2], outs["jax"][:2]):
        np.testing.assert_array_equal(got_ids, want_ids)
        assert_logits_close(got_logits, want_logits, 1e-4, "Generator")
    np.testing.assert_array_equal(outs["port"][2][0], outs["jax"][2][0])


def test_backend_through_answer_generator_matches_jax(tmp_path, generator_pair):
    tok = make_tokenizer(tmp_path)
    questions = ["who is w3 ?", "where was w7 born ?"]
    contexts = [["w3 is the king of w103 ."], ["w7 was born in the city w107 .", "w8 died ."]]
    outs = {}
    for name, backend in backends(generator_pair, tok.sep_token_id).items():
        reader = (JaxAnswerGenerator if name == "jax" else AnswerGenerator)(
            tok, backend, model_name="t5-tiny", is_chat=False, max_new_tokens=6, batch_size=2)
        ids, logits = reader.generator_generate(*reader.get_generator_inputs(questions, contexts))
        outs[name] = (ids, logits, reader.generate_answer(questions, context=contexts),
                      reader.generate_answer(questions[0]))
    np.testing.assert_array_equal(outs["port"][0], outs["jax"][0])
    assert_logits_close(outs["port"][1], outs["jax"][1], 1e-4, "AnswerGenerator")
    assert outs["port"][2:] == outs["jax"][2:]


def test_backend_left_and_right_padding_agree(generator_pair):
    *_, pp, config = generator_pair
    backend = t5.TorchT5Backend(pp, config, eos_token_id=1, compute_dtype=torch.float32,
                                prompt_buckets=(16,), device="cpu")
    rng = np.random.RandomState(9)
    lengths = (12, 7)
    right = np.zeros((2, 12), np.int32)
    left = np.zeros((2, 12), np.int32)
    for row, n in enumerate(lengths):
        right[row, :n] = left[row, 12 - n:] = rng.randint(5, 287, size=n)
    ids_r, logits_r = backend.greedy(right, (right > 0).astype(np.int32), 5)
    ids_l, logits_l = backend.greedy(left, (left > 0).astype(np.int32), 5)
    np.testing.assert_array_equal(ids_l, ids_r)
    assert_logits_close(logits_l, logits_r, 1e-5, "left against right padding")


def test_entry_points_need_a_gpu(monkeypatch, generator_pair, tmp_path):
    *_, pp, config = generator_pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t5.TorchT5Backend(pp, config, eos_token_id=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t5.t5_params_from_jax({"shared": np.zeros((4, 2), np.float32)})
    (tmp_path / "config.json").write_text(json.dumps(hf_config()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t5.load_t5(str(tmp_path))
    with pytest.raises(ValueError, match="lie on cpu"):
        t5.TorchT5Backend(pp, config, eos_token_id=1, device="meta")
