"""Tensor-parallel BERT in the port (``models/bert.py``'s ``param_shardings``,
``shard_bert_model`` and ``Encoder.shard_params``) against
``kirag_tpu.models.bert.param_shardings`` and
``kirag_tpu.models.encoders.Encoder(...).shard_params(create_mesh(d, m))``.

The port's ranks are gloo processes on the CPU (``tests/torch_dist.py``),
started once per world size for the module: ``(1, 2)`` at 2 ranks, ``(2, 2)``
and ``(1, 4)`` at 4; the reference shards over as many of ``conftest.py``'s
virtual CPU devices. Both get the same numpy weights (a tiny BERT: hidden 32,
2 layers, 4 heads, intermediate 64) with the fused and the unfused QKV.
Tolerance: f32 embeddings within 1e-5 of the largest magnitude (partial
products summed over the model axis in another order). Every rank returns
the same embeddings, holds 1/M of each sharded leaf and the whole of each
replicated one, and the caller's model keeps its shapes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kirag_tpu.models import BertConfig as JaxBertConfig
from kirag_tpu.models import init_bert_params
from kirag_tpu.models.bert import param_shardings as jax_param_shardings
from kirag_tpu.models.encoders import Encoder as JaxEncoder
from kirag_tpu.parallel import create_mesh as jax_create_mesh
from kirag_tpu_torch.models import BertConfig
from kirag_tpu_torch.models.bert import (
    check_tensor_parallel,
    param_shardings,
    state_dict_shardings,
)
from torch_dist import run_ranks

TINY = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, max_position_embeddings=64)
MESHES = {2: [(1, 2)], 4: [(2, 2), (1, 4)]}
TOL = 1e-5


@functools.lru_cache(maxsize=None)
def jax_tree(**cfg):
    return jax.tree.map(np.asarray, init_bert_params(jax.random.key(3), JaxBertConfig(**cfg)))


def make_case(mesh, fused=True, encoder_type="e5", **over):
    cfg = {**TINY, "fused_qkv": fused, **over}
    tree = jax_tree(**{k: v for k, v in cfg.items() if k != "fused_qkv"})
    rng = np.random.RandomState(5)
    ids = rng.randint(1, cfg["vocab_size"], (6, 16)).astype(np.int32)
    mask = (np.arange(16)[None] < rng.randint(3, 17, (6, 1))).astype(np.int32)
    return {"cfg": cfg, "tree": tree, "ids": ids * mask, "mask": mask, "mesh": mesh,
            "encoder_type": encoder_type}


CASES = {f"{d}x{m}-{'fused' if fused else 'unfused'}": make_case((d, m), fused)
         for world in MESHES for d, m in MESHES[world] for fused in (True, False)}
CASES["1x2-bge"] = make_case((1, 2), encoder_type="bge")
# a model axis that divides neither the heads nor the intermediate size
REFUSED = {"1x4-heads": make_case((1, 4), num_attention_heads=2),
           "1x4-intermediate": make_case((1, 4), intermediate_size=66)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bert_tp")
    every = {**CASES, **REFUSED}
    out = {}
    for world in MESHES:
        names = [n for n, c in every.items() if c["mesh"][0] * c["mesh"][1] == world]
        got = run_ranks("bert_tp", world, [every[n] for n in names], tmp)
        out.update({n: [r[i] for r in got] for i, n in enumerate(names)})
    return out


def spec_dim(spec):
    """The dim a PartitionSpec shards over "model" (None: replicated)."""
    return next((i for i, axis in enumerate(spec) if axis == "model"), None)


@pytest.mark.parametrize("layers", [1, 3])
def test_param_shardings_match_jax(layers):
    """Leaf for leaf the reference's specs, as the dim each shards on."""
    cfg = {**TINY, "num_hidden_layers": layers}
    want = jax.tree.map(spec_dim, jax_param_shardings(JaxBertConfig(**cfg)),
                        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    got = param_shardings(BertConfig(**cfg))
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    assert jax.tree.leaves(got, is_leaf=lambda x: x is None) == jax.tree.leaves(
        want, is_leaf=lambda x: x is None)


@pytest.mark.parametrize("fused", [True, False])
def test_state_dict_shardings_name_every_parameter(fused):
    """Column-parallel nn.Linear weights shard on dim 0, row-parallel ones on
    dim 1 (their biases replicate), every other leaf replicates."""
    from kirag_tpu_torch.models import BertModel

    config = BertConfig(**TINY, fused_qkv=fused)
    dims = state_dict_shardings(config)
    assert set(dims) == set(BertModel(config, device="meta").state_dict())
    sharded = {k: v for k, v in dims.items() if v is not None}
    col = ["qkv"] if fused else ["query", "key", "value"]
    want = {}
    for i in range(config.num_hidden_layers):
        for n in col:
            want.update({f"layers.{i}.attention.{n}.weight": 0, f"layers.{i}.attention.{n}.bias": 0})
        want.update({f"layers.{i}.attention.output.weight": 1,
                     f"layers.{i}.mlp.intermediate.weight": 0,
                     f"layers.{i}.mlp.intermediate.bias": 0, f"layers.{i}.mlp.output.weight": 1})
    assert sharded == want


@functools.lru_cache(maxsize=None)
def jax_embeddings(mesh_shape, encoder_type):
    """The reference's sharded embeddings of CASES' weights and batch (the
    same in every case: the port's fused and unfused QKV hold one set of
    weights)."""
    case = CASES[f"{mesh_shape[0]}x{mesh_shape[1]}-fused"]
    data, model = mesh_shape
    cfg = {k: v for k, v in case["cfg"].items() if k != "fused_qkv"}
    mesh = jax_create_mesh(data, model, devices=jax.devices()[:data * model])
    enc = JaxEncoder(jax.tree.map(jnp.asarray, case["tree"]), JaxBertConfig(**cfg),
                     encoder_type).shard_params(mesh)
    return np.asarray(enc(case["ids"], case["mask"]))


@pytest.mark.parametrize("name", list(CASES))
def test_shard_params_matches_jax(name, ranks):
    case = CASES[name]
    want = jax_embeddings(case["mesh"], case["encoder_type"])
    got = ranks[name]
    assert got[0]["emb"].shape == want.shape
    for r in got:
        np.testing.assert_array_equal(r["emb"], got[0]["emb"])  # every rank the same
        assert r["caller_untouched"]
    np.testing.assert_allclose(got[0]["emb"], want, rtol=0, atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("name", [n for n in CASES if "bge" not in n])
def test_each_rank_holds_its_shards(name, ranks):
    """1/M of each sharded leaf along the dim it shards on, the whole of the
    replicated ones; the bytes add up to that."""
    from kirag_tpu_torch.models import BertModel

    case = CASES[name]
    m = case["mesh"][1]
    config = BertConfig(**case["cfg"])
    whole = {n: tuple(p.shape) for n, p in BertModel(config, device="meta").named_parameters()}
    dims = state_dict_shardings(config)
    want = {}
    for n, shape in whole.items():
        shape = list(shape)
        if dims[n] is not None:
            shape[dims[n]] //= m
        want[n] = tuple(shape)
    for r in ranks[name]:
        assert r["shapes"] == want
        sharded = sum(int(np.prod(whole[n])) for n in whole if dims[n] is not None)
        assert r["bytes"] == (4 * sum(int(np.prod(s)) for s in whole.values()),
                              r["bytes"][0] - 4 * sharded + 4 * sharded // m)


@pytest.mark.parametrize("name", list(REFUSED))
def test_model_axis_must_divide(name, ranks):
    what = "attention heads" if "heads" in name else "intermediate size"
    for r in ranks[name]:
        assert "cannot shard" in r["refused"] and what in r["refused"]
    with pytest.raises(ValueError, match=what):
        check_tensor_parallel(BertConfig(**REFUSED[name]["cfg"]), 4)
    check_tensor_parallel(BertConfig(**TINY), 4)  # 4 heads, 64 columns: fine
