"""Data- and tensor-parallel Aligner training in the port
(``AlignerTrainer(mesh=create_mesh(d, m), batch_sharding="data")``) against
the reference's program over the same mesh and against the port's unsharded
trainer, at ``(2, 1)``, ``(1, 2)`` and ``(2, 2)``.

The reference's side is its loss and gradients: unsharded for every mesh,
and at ``(2, 2)`` the GSPMD program that its ``AlignerTrainer(mesh=,
batch_sharding=NamedSharding(mesh, P("data")))`` runs, the same loss
jitted over parameters placed by its ``param_shardings`` and the batch over
"data" (its optax step, held to the port's elsewhere, left out: compiling
the whole sharded trainer costs 13 s a mesh here). Its own tests hold its
meshes to its unsharded trainer.

The port's ranks are gloo processes on the CPU (``tests/torch_dist.py``),
started once per world size for the module, running the cases of
``torch_dist_tasks.aligner`` in order; the reference runs in this process
on ``conftest.py``'s virtual CPU devices. Both get the same numpy weights (a
tiny BERT: hidden 32, 2 layers, 4 heads) and the same collated batches (4
queries of 4 docs each). Tolerances, f32: each step's loss within 1e-5
relative; each gradient leaf (summed over the data axis, gathered over the
model axis) within 1e-5 of its norm, plus 1e-9 for the leaves whose
gradient is zero in exact arithmetic (the key bias: softmax does not see
it); parameters after two steps within 2 x the learning rate (Adam's first
step at a non-zero rate moves each element by about lr x sign(g), which
flips where g is near 0; the first update of the warmup is at rate 0).
Resume on the same mesh is bitwise; a checkpoint of one layout loads under
another and unsharded.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec

from kirag_tpu.models import BertConfig as JaxBertConfig
from kirag_tpu.models.bert import param_shardings as jax_param_shardings
from kirag_tpu.models.encoders import Encoder as JaxEncoder
from kirag_tpu.parallel import create_mesh as jax_create_mesh
from kirag_tpu.training import in_batch_contrastive_loss as jax_loss
from kirag_tpu_torch.data import E5Collator
from kirag_tpu_torch.training import AlignerTrainer

import torch_dist_tasks as tasks
from tests.helpers import make_tokenizer
from tests.test_torch_training import examples, flat_jax, jax_params, to_jax
from torch_dist import run_ranks

LR = 3e-4
STEPS = 2


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_training")
    tok = make_tokenizer(tmp)
    cfg = dict(vocab_size=tok.vocab_size, hidden_size=32, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=64, max_position_embeddings=64)
    coll = E5Collator(tokenizer=tok, query_maxlength=32, doc_maxlength=32)
    ex = examples()
    batches = [coll(ex[4 * i:4 * i + 4]) for i in range(3)]
    # packed: docs cut to 8 tokens, 4 to a 32-token row
    short = [(q, {k: v[:, :8] for k, v in d.items()}, p, i) for q, d, p, i in batches]
    return {"tmp": tmp, "cfg": cfg, "tree": jax_params(cfg), "batches": batches,
            "short": short, "eval": [coll(ex[8:12]), coll(ex[12:16])],
            "odd": [coll(ex[:3])]}


def case_list(d):
    """name -> (world, case), run in this order in each world."""
    tmp = d["tmp"]
    base = {"cfg": d["cfg"], "tree": d["tree"], "batches": d["batches"],
            "tcfg": {"learning_rate": LR}}

    def case(op, mesh, name, **kw):
        return name, (mesh[0] * mesh[1], {**base, "op": op, "mesh": mesh,
                                          "save_dir": str(tmp / name), **kw})

    return dict([
        case("step", (2, 1), "dp", steps=STEPS, eval=d["eval"]),
        case("step", (1, 2), "tp", steps=STEPS, eval=d["eval"], checkpoint=True,
             save_encoder=str(tmp / "tp_encoder")),
        case("step", (1, 2), "tp-remat", steps=STEPS, remat=True),
        case("step", (1, 2), "tp-dots-packed-acc2", steps=STEPS, remat="dots", packed=True,
             batches=d["short"], tcfg={"learning_rate": LR, "accumulation_steps": 2}),
        case("step", (2, 1), "replicated", steps=STEPS, batch_sharding=None),
        case("resume", (2, 1), "resume-dp"),
        case("resume", (1, 2), "resume-tp"),
        case("load", (2, 1), "load-tp-at-dp", **{"from": str(tmp / "tp")}),
        case("nonfinite", (2, 1), "nonfinite-dp"),
        case("nonfinite", (1, 2), "nonfinite-tp"),
        case("rows", (2, 1), "rows", batches=d["odd"]),
        case("writes", (1, 2), "writes", eval=d["eval"][:1],
             tcfg={"learning_rate": LR, "max_steps": 2}),
        case("step", (2, 2), "dp-tp", steps=STEPS, eval=d["eval"]),
        case("resume", (2, 2), "resume-dp-tp"),
    ])


@pytest.fixture(scope="module")
def ranks(data):
    cases = case_list(data)
    out = {}
    for world in (2, 4):
        names = [n for n, (w, _) in cases.items() if w == world]
        got = run_ranks("aligner", world, [cases[n][1] for n in names], data["tmp"])
        out.update({n: [r[i] for r in got] for i, n in enumerate(names)})
    return out


def unsharded(data, name, steps=STEPS):
    """The port's unsharded trainer over the same case: its evaluation before
    the steps, the first step's gradients, every step's statistics, the
    parameters after, the trainer (a new one each call: the caller may step
    it on)."""
    case = {**case_list(data)[name][1], "batch_sharding": None}
    case["save_dir"] += "-unsharded"
    trainer = tasks._aligner_trainer(case, None, case["save_dir"])
    evaluated = None if trainer.eval_loader is None else (
        trainer.evaluate(trainer.model, trainer.eval_loader),
        trainer.evaluate_corpus_mrr(trainer.model, trainer.eval_loader))
    seen = tasks._record_grads(trainer)
    stats = tasks._steps(trainer, steps)
    return {"eval": evaluated, "grads": seen[0], "stats": stats,
            "params": tasks._whole_params(trainer), "trainer": trainer}


def jax_sharded_gradients(data, mesh_shape):
    """The reference's loss and gradients of the first batch over a (data,
    model) mesh of virtual devices: its trainer's program, the weights
    placed by ``param_shardings``, the batch sharded over "data"."""
    d, m = mesh_shape
    mesh = jax_create_mesh(d, m, devices=jax.devices()[:d * m])
    config = JaxBertConfig(**data["cfg"])
    params = jax.tree.map(lambda p, spec: jax.device_put(jnp.asarray(p), NamedSharding(mesh, spec)),
                          data["tree"], jax_param_shardings(config))
    batch = jax.tree.map(
        lambda x: jax.device_put(jnp.asarray(x), NamedSharding(mesh, PartitionSpec("data"))),
        AlignerTrainer.pack_batch(data["batches"][0]))
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jax_loss(p, batch, config, "e5", 0.05), has_aux=True))(params)
    return float(loss), flat_jax(grads)


@pytest.fixture(scope="module")
def jax_gradients(data):
    """The reference's loss and gradients of the first batch, unsharded."""
    batch = to_jax(AlignerTrainer.pack_batch(data["batches"][0]))
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jax_loss(p, batch, JaxBertConfig(**data["cfg"]), "e5", 0.05),
        has_aux=True))(jax.tree.map(jnp.asarray, data["tree"]))
    return float(loss), flat_jax(grads)


def check_grads(got, want):
    assert got.keys() == want.keys()
    for k in want:
        gap = np.linalg.norm(got[k] - want[k])
        assert gap <= 1e-5 * np.linalg.norm(want[k]) + 1e-9, (k, gap)


def check_params(got, want, tol=2 * LR):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol, err_msg=k)


def check_same_ranks(got):
    for r in got[1:]:
        for a, b in zip(r["stats"], got[0]["stats"]):
            assert a["loss"] == b["loss"]
        for k in got[0]["params"]:
            np.testing.assert_array_equal(r["params"][k], got[0]["params"][k])


@pytest.mark.parametrize("name", ["dp", "tp", "dp-tp"])
def test_step_matches_jax_and_unsharded(name, data, ranks, jax_gradients):
    """The first step's loss and gradients against the reference's (its
    unsharded loss: its own tests hold its meshes to it) and the port's
    unsharded trainer's; two steps' statistics and the parameters after
    against the port's unsharded trainer; every rank the same; the
    evaluations (block and corpus MRR) equal to the unsharded trainer's."""
    got = ranks[name]
    check_same_ranks(got)
    ref = unsharded(data, name)
    for a, b in zip(got[0]["stats"], ref["stats"]):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        for key in ("grad_norm", "grad_min", "grad_max", "grad_mean", "accuracy"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-5, atol=1e-9, err_msg=key)
    jax_loss_0, jax_grads = jax_gradients
    np.testing.assert_allclose(got[0]["stats"][0]["loss"], jax_loss_0, rtol=1e-5)
    check_grads(got[0]["grads"], jax_grads)
    check_grads(got[0]["grads"], ref["grads"])
    check_params(got[0]["params"], ref["params"])
    assert [r["eval"] for r in got] == [ref["eval"]] * len(got)


def test_dp_tp_step_matches_jax_over_the_same_mesh(data, ranks):
    """At (2, 2) against the reference's sharded program over a 2 x 2 mesh
    of virtual devices (the batch sharded over "data", the weights over
    "model"): the first step's loss and every gradient."""
    loss, grads = jax_sharded_gradients(data, (2, 2))
    got = ranks["dp-tp"][0]
    np.testing.assert_allclose(got["stats"][0]["loss"], loss, rtol=1e-5)
    check_grads(got["grads"], grads)


@pytest.mark.parametrize("name", ["tp-remat", "tp-dots-packed-acc2", "replicated"])
def test_variants_match_unsharded(name, data, ranks):
    """remat True and "dots" under TP (the recomputation repeats the
    forward's collectives), packed, two accumulated micro steps; and a
    replicated batch over a mesh (no gradient sum: no double count)."""
    got = ranks[name]
    check_same_ranks(got)
    ref = unsharded(data, name)
    for a, b in zip(got[0]["stats"], ref["stats"]):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-5)
    check_grads(got[0]["grads"], ref["grads"])
    check_params(got[0]["params"], ref["params"])
    if name == "tp-dots-packed-acc2":  # one update of two micro steps, at rate 0
        assert ref["trainer"].optimizer.count == 1


@pytest.mark.parametrize("name", ["resume-dp", "resume-tp", "resume-dp-tp"])
def test_resume_is_bitwise_on_the_same_mesh(name, ranks):
    for r in ranks[name]:
        (u_stats, u_params), (r_stats, r_params) = r["uninterrupted"], r["resumed"]
        assert u_stats == r_stats
        for k in u_params:
            np.testing.assert_array_equal(r_params[k], u_params[k])


def test_checkpoint_does_not_depend_on_the_mesh(data, ranks):
    """The (1, 2) run's checkpoint (after two steps) is the unsharded
    trainer's format: an unsharded trainer loads it equal to the gathered
    parameters, and so does a (2, 1) mesh; one more step from there in both
    matches the unsharded run's third step within the step's tolerance."""
    tp_params = ranks["tp"][0]["params"]
    case = {**case_list(data)["tp"][1], "batch_sharding": None}
    loader = tasks._aligner_trainer(case, None, str(data["tmp"] / "tp"))
    assert loader.resume_training() and loader.step == STEPS
    loaded = tasks._whole_params(loader)
    for r in ranks["load-tp-at-dp"]:
        for k in tp_params:
            np.testing.assert_array_equal(loaded[k], tp_params[k])
            np.testing.assert_array_equal(r["loaded"][k], tp_params[k])
    third = loader.training_step(data["batches"][0])
    ref = unsharded(data, "tp")["trainer"]
    want = ref.training_step(data["batches"][0])
    np.testing.assert_allclose(third["loss"], want["loss"], rtol=1e-5)
    got = ranks["load-tp-at-dp"][0]
    np.testing.assert_allclose(got["stats"][0]["loss"], want["loss"], rtol=1e-5)
    check_params(got["params"], tasks._whole_params(ref))
    check_params(tasks._whole_params(loader), tasks._whole_params(ref))


def test_save_encoder_under_tp_is_read_by_jax(data, ranks):
    enc = JaxEncoder.load(str(data["tmp"] / "tp_encoder"))
    got = flat_jax(enc.params)
    want = ranks["tp"][0]["params"]
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("name", ["nonfinite-dp", "nonfinite-tp"])
def test_nonfinite_step_skipped_on_every_rank(name, ranks):
    """A NaN gradient on the last rank only: every rank skips the micro
    step (the data axis sums it in, the model axis agrees the flag)."""
    for r in ranks[name]:
        assert r["unchanged"] and r["skips"] == (1, 1, 0)
        assert np.isnan(r["stats"][0]["grad_norm"])


def test_rows_that_do_not_divide_the_data_axis_raise(ranks):
    for r in ranks["rows"]:
        assert "do not divide" in r["error"]


def test_only_the_first_rank_writes(data, ranks):
    first, other = ranks["writes"]
    assert other["files"] == [] and first["history"] == other["history"] > 0
    assert {"configs.json", "metrics.jsonl", "latest/2/state.pt",
            "best/2/state.pt", "best/2/metric.json"} <= set(first["files"])
    # the best checkpoint of a step that is also the latest is one file
    run = data["tmp"] / "writes" / "0"
    assert (run / "best/2/state.pt").samefile(run / "latest/2/state.pt")


def test_each_tp_rank_holds_its_shards(ranks):
    whole = ranks["dp"][0]["bytes"]
    for r in ranks["tp"]:
        assert whole / 2 < r["bytes"] < whole  # embeddings and norms replicate
    assert [r["bytes"] for r in ranks["dp-tp"]] == [ranks["tp"][0]["bytes"]] * 4
