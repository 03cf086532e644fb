"""Aligner training, the port against the JAX package (``kirag_tpu.training``).

Both packages get the same numpy weights (a tiny BERT: hidden 32, 2 layers,
4 heads), the same tokenizer (``tests.helpers.make_tokenizer``) and the same
batches; everything runs on the CPU in f32. Tolerances: the loss and every
gradient leaf within atol = rtol = 1e-5 (sums in other orders); optimizer
steps on identical gradients within 1e-7 (the same f32 arithmetic, pow and
division rounded by two libraries); parameters after a few full training
steps within 1e-5 (the gradients' 1e-7 relative differences, through Adam's
normalised steps of size 3e-4).
"""

import functools
import json
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kirag_tpu.cli import train_aligner as jax_cli
from kirag_tpu.data import E5Collator as JaxE5Collator
from kirag_tpu.data import KGChainRetrieverSeqSampleDataset as JaxSeqSampleDataset
from kirag_tpu.models import BertConfig as JaxBertConfig
from kirag_tpu.models import init_bert_params
from kirag_tpu.models.encoders import Encoder as JaxEncoder
from kirag_tpu.training import AlignerTrainer as JaxAlignerTrainer
from kirag_tpu.training import DataLoader as JaxDataLoader
from kirag_tpu.training import TrainerConfig as JaxTrainerConfig
from kirag_tpu.training import in_batch_contrastive_loss as jax_loss
from kirag_tpu.training.trainer import make_optimizer as jax_make_optimizer
from kirag_tpu_torch.cli import train_aligner
from kirag_tpu_torch.data import (
    E5Collator,
    KGChainRetrieverSeqSampleDataset,
    RetrieverCollator,
    bucket_length,
)
from kirag_tpu_torch.models import BertConfig, BertModel, load_encoder, params_from_jax
from kirag_tpu_torch.models import bert as port_bert
from kirag_tpu_torch.models.encoders import _jax_flat_params
from kirag_tpu_torch.training import AlignerTrainer, DataLoader, TrainerConfig
from kirag_tpu_torch.training import in_batch_contrastive_loss, make_optimizer
from kirag_tpu_torch.training.aligner import _embed

from tests.helpers import make_tokenizer
from tests.test_torch_cli import save_hf_encoder

TOL = dict(atol=1e-5, rtol=1e-5)


def bert_config(vocab_size, **kw):
    return dict(vocab_size=vocab_size, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=64, max_position_embeddings=64, **kw)


def jax_params(cfg):
    return jax.tree.map(np.asarray, init_bert_params(jax.random.key(0), JaxBertConfig(**cfg)))


def port_model(params, cfg) -> BertModel:
    model = BertModel(BertConfig(**cfg))
    model.load_state_dict(params_from_jax(params, BertConfig(**cfg)))
    return model


def flat_jax(tree):
    """The pytree's leaves by '/'-joined path, as ``_jax_flat_params`` names them."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        out[key] = np.asarray(leaf)
    return out


def flat_port_grads(model):
    """The model's gradients in the JAX layout (unused parameters as zeros)."""
    grads = BertModel(model.config)
    grads.load_state_dict({n: torch.zeros_like(p) if p.grad is None else p.grad
                           for n, p in model.named_parameters()})
    return _jax_flat_params(grads)


def examples(n=24, num_negatives=3, seed=0):
    """The JAX package's trainer-test examples: word i's question, its
    positive passage, random other words as negatives."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        negs = [f"w{j} w{j + 50}" for j in rng.choice(100, size=num_negatives) if j != i]
        while len(negs) < num_negatives:
            negs.append("omega psi")
        out.append({"index": i, "question": f"w{i} question", "answers": [],
                    "positive_passage": f"w{i} w{i + 50}",
                    "negative_passages": negs[:num_negatives]})
    return out


def to_jax(batch):
    return jax.tree.map(jnp.asarray, batch)


def to_torch(batch):
    return {k: to_torch(v) if isinstance(v, dict) else torch.from_numpy(np.asarray(v)).long()
            for k, v in batch.items()}


def collated_batch(tmp_path, n=4):
    tok = make_tokenizer(tmp_path)
    collated = JaxE5Collator(tokenizer=tok, query_maxlength=32, doc_maxlength=32)(
        examples()[:n])
    return tok, AlignerTrainer.pack_batch(collated)


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("packed", [False, True])
def test_loss_and_gradients_match_jax(tmp_path, monkeypatch, impl, packed):
    """One step's loss and every gradient leaf, f32. ``flash``: the port's
    flash path (the Function, plain kernels on the CPU) against JAX's XLA path
    (its flash path needs a TPU); ``packed``: queries and docs in one forward
    (docs padded to 8 tokens, 4 to a 32-token row)."""
    tok, batch = collated_batch(tmp_path)
    if packed:
        batch["doc_args"] = {k: v[:, :8] for k, v in batch["doc_args"].items()}
    cfg = bert_config(tok.vocab_size)
    params = jax_params(cfg)
    (want, aux), grads = jax.value_and_grad(
        lambda p: jax_loss(p, to_jax(batch), JaxBertConfig(**cfg), "e5", 0.05, packed=packed),
        has_aux=True)(jax.tree.map(jnp.asarray, params))
    monkeypatch.setattr(port_bert, "_resolve_attention_impl", lambda *args: impl)
    model = port_model(params, cfg)
    loss, port_aux = in_batch_contrastive_loss(model, to_torch(batch), "e5", 0.05,
                                               packed=packed)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), **TOL)
    assert float(port_aux["accuracy"]) == float(aux["accuracy"])
    got, ref = flat_port_grads(model), flat_jax(grads)
    assert got.keys() == ref.keys()
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], **TOL, err_msg=name)


def test_optimizer_matches_optax_on_the_same_gradients():
    """Warmup from lr 0, clipping (gradients of norm about 10 against 1),
    accumulation of 2 micro steps, a NaN micro step skipped and counted."""
    rng = np.random.RandomState(0)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2, 2)}
    start = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(learning_rate=0.1, weight_decay=0.01, warmup_ratio=0.5, accumulation_steps=2,
              max_grad_norm=1.0)
    opt = jax_make_optimizer(JaxTrainerConfig(**kw), total_steps=12)
    jp = jax.tree.map(jnp.asarray, start)
    state = opt.init(jp)
    params = [torch.nn.Parameter(torch.from_numpy(start[k].copy())) for k in sorted(shapes)]
    port = make_optimizer(TrainerConfig(**kw), 12, params)
    assert port.warmup_steps == 3
    for step in range(11):
        g = {k: (rng.randn(*s) * (3 if step % 3 else 0.1)).astype(np.float32)
             for k, s in shapes.items()}
        if step == 4:
            g["b"][2] = np.nan
        updates, state = opt.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        stats = port.update([torch.from_numpy(g[k]) for k in sorted(shapes)])
        for k, p in zip(sorted(shapes), params):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), atol=1e-7,
                                       rtol=1e-7)
        assert port.notfinite_count == int(state.notfinite_count)
        assert port.total_notfinite == int(state.total_notfinite)
        if step == 1:  # the first update runs at lr 0: nothing moved
            for k, p in zip(sorted(shapes), params):
                np.testing.assert_array_equal(p.detach().numpy(), start[k])
        if step == 4:
            assert np.isnan(stats["grad_norm"]) and port.mini_step == 0
    assert port.count == 5 and port.total_notfinite == 1


def trainers(tmp_path, batch_size=4, eval_too=True, **cfg_kw):
    """The JAX package's trainer and the port's on the same weights, batches
    (E5 collator over the examples) and configuration."""
    tok = make_tokenizer(tmp_path)
    cfg = bert_config(tok.vocab_size)
    params = jax_params(cfg)
    cfg_kw.setdefault("eval_steps", 1000)
    cfg_kw.setdefault("log_steps", 1000)
    out = []
    for pkg in ("jax", "port"):
        save_dir = str(tmp_path / pkg)
        if pkg == "jax":
            coll = JaxE5Collator(tokenizer=tok, query_maxlength=32, doc_maxlength=32)
            loaders = [JaxDataLoader(examples(), batch_size=batch_size, shuffle=True,
                                     collate_fn=coll, seed=0),
                       JaxDataLoader(examples()[:8], batch_size=batch_size, shuffle=False,
                                     collate_fn=coll) if eval_too else None]
            out.append(JaxAlignerTrainer(
                jax.tree.map(jnp.asarray, params), JaxBertConfig(**cfg),
                JaxTrainerConfig(learning_rate=3e-4, save_dir=save_dir, num_train_epochs=2,
                                 **cfg_kw), *loaders, temperature=0.05))
        else:
            coll = E5Collator(tokenizer=tok, query_maxlength=32, doc_maxlength=32)
            loaders = [DataLoader(examples(), batch_size=batch_size, shuffle=True,
                                  collate_fn=coll, seed=0),
                       DataLoader(examples()[:8], batch_size=batch_size, shuffle=False,
                                  collate_fn=coll) if eval_too else None]
            out.append(AlignerTrainer(
                port_model(params, cfg),
                TrainerConfig(learning_rate=3e-4, save_dir=save_dir, num_train_epochs=2,
                              **cfg_kw), *loaders, temperature=0.05))
    return out


def test_training_steps_match_jax(tmp_path):
    """Four micro steps (two updates of two accumulated micro batches, the
    first at lr 0): the same losses and statistics, then the same weights."""
    jax_t, port_t = trainers(tmp_path, accumulation_steps=2, warmup_ratio=0.25)
    jax_t.train_loader.set_epoch(0)
    port_t.train_loader.set_epoch(0)
    for _, jb, pb in zip(range(4), jax_t.train_loader, port_t.train_loader):
        want, got = jax_t.training_step(jb), port_t.training_step(pb)
        for key in ("loss", "accuracy", "grad_norm", "grad_min", "grad_max", "grad_mean"):
            np.testing.assert_allclose(got[key], want[key], **TOL, err_msg=key)
    ref = flat_jax(jax_t.params)
    got = _jax_flat_params(port_t.model)
    moved = max(float(np.abs(got[k] - flat_jax(jax_params(
        bert_config(port_t.model.config.vocab_size)))[k]).max()) for k in ref)
    assert moved > 1e-4  # the second update changed the weights
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], **TOL, err_msg=name)
    assert port_t.optimizer.count == 2


@pytest.mark.parametrize("packed", [False, True])
def test_remat_modes_are_gradient_equal(tmp_path, monkeypatch, packed):
    """remat=True (checkpoint) and "dots" (selective checkpoint keeping the
    matmuls) recompute the same forward, K3's flash path included."""
    tok, batch = collated_batch(tmp_path)
    if packed:
        batch["doc_args"] = {k: v[:, :8] for k, v in batch["doc_args"].items()}
    cfg = bert_config(tok.vocab_size)
    monkeypatch.setattr(port_bert, "_resolve_attention_impl", lambda *args: "flash")
    model = port_model(jax_params(cfg), cfg)
    grads = {}
    for remat in (False, True, "dots"):
        model.zero_grad()
        loss, _ = in_batch_contrastive_loss(model, to_torch(batch), "e5", 0.05, remat=remat,
                                            packed=packed)
        loss.backward()
        grads[remat] = flat_port_grads(model)
    for remat in (True, "dots"):
        for name, g in grads[False].items():
            np.testing.assert_allclose(grads[remat][name], g, atol=1e-7, rtol=0,
                                       err_msg=f"{remat} {name}")


def test_loss_falls_and_mrr_rises(tmp_path):
    _, trainer = trainers(tmp_path)
    mrr_before = trainer.evaluate(trainer.model, trainer.eval_loader)
    losses = []
    trainer.train_loader.set_epoch(0)
    for _ in range(3):
        for batch in trainer.train_loader:
            losses.append(trainer.training_step(batch)["loss"])
    mrr_after = trainer.evaluate(trainer.model, trainer.eval_loader)
    assert np.mean(losses[-4:]) < np.mean(losses[:4])
    assert mrr_after > mrr_before
    corpus = trainer.evaluate_corpus_mrr(trainer.model, trainer.eval_loader)
    assert 0.0 < corpus <= mrr_after + 1e-6


def test_eval_metrics_match_jax(tmp_path):
    jax_t, port_t = trainers(tmp_path)
    assert port_t.evaluate(port_t.model, port_t.eval_loader) == pytest.approx(
        jax_t.evaluate(jax_t.params, jax_t.eval_loader), abs=1e-6)
    assert port_t.evaluate_corpus_mrr(port_t.model, port_t.eval_loader) == pytest.approx(
        jax_t.evaluate_corpus_mrr(jax_t.params, jax_t.eval_loader), abs=1e-6)


def test_resume_mid_epoch_repeats_the_losses(tmp_path):
    """Interrupt mid-epoch, resume from the checkpoint: the losses of every
    later step equal those of an uninterrupted run (loader fast-forward,
    model, Adam's moments, the accumulator and the counts restored)."""
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    kw = dict(log_steps=1, eval_too=False, accumulation_steps=2)
    full = trainers(tmp_path / "a", **kw)[1]
    full.train()
    full_losses = {r["step"]: r["loss"] for r in full.history if "loss" in r}
    assert len(full_losses) == 12

    interrupted = trainers(tmp_path / "b", **kw)[1]
    interrupted.train_loader.set_epoch(0)
    for i, batch in enumerate(interrupted.train_loader):
        interrupted.training_step(batch)
        if i == 2:  # mid-epoch and mid-accumulation (6 micro steps per epoch)
            break
    interrupted.save_checkpoint()

    resumed = trainers(tmp_path / "b", **kw)[1]
    resumed.train(resume=True)
    resumed_losses = {r["step"]: r["loss"] for r in resumed.history if "loss" in r}
    assert min(resumed_losses) == 4 and max(resumed_losses) == 12
    for step, loss in resumed_losses.items():
        assert loss == full_losses[step], step


def test_checkpoints_metrics_and_retention(tmp_path):
    _, trainer = trainers(tmp_path, log_steps=1, keep_top_k=2)
    trainer.train_loader.set_epoch(0)
    stats = trainer.training_step(next(iter(trainer.train_loader)))
    for key in ("grad_norm", "grad_min", "grad_max", "grad_mean"):
        assert np.isfinite(stats[key])
    assert stats["grad_min"] <= stats["grad_mean"] <= stats["grad_max"]
    seen = []
    trainer.trackers.append(seen.append)
    trainer.log(stats)
    rec = json.loads((tmp_path / "port" / "metrics.jsonl").read_text().splitlines()[-1])
    assert rec["step"] == 1 and rec["loss"] == stats["loss"] and "time" in rec
    assert seen == trainer.history[-1:]
    for metric in (0.1, 0.5, 0.3, 0.9):
        trainer.step += 1
        trainer.save_checkpoint(metric=metric)
    assert trainer.best.all_steps() == [3, 5] and trainer.best_checkpoint_step() == 5
    assert trainer.latest.all_steps() == [5]


def test_save_encoder_is_read_by_jax(tmp_path):
    _, trainer = trainers(tmp_path, eval_too=False)
    trainer.train_loader.set_epoch(0)
    for _, batch in zip(range(3), trainer.train_loader):
        trainer.training_step(batch)
    out = str(tmp_path / "encoder")
    trainer.save_encoder(out)
    ids = np.asarray([[2, 30, 31, 40, 3, 0], [2, 50, 3, 0, 0, 0]], np.int32)
    mask = (ids > 0).astype(np.int32)
    jax_emb = np.asarray(JaxEncoder.load(out)(ids, mask))
    with torch.no_grad():
        port_emb = _embed(trainer.model, {"input_ids": torch.from_numpy(ids).long(),
                                          "attention_mask": torch.from_numpy(mask).long()},
                          "e5", torch.float32)
    np.testing.assert_allclose(port_emb.numpy(), jax_emb, **TOL)
    reloaded = load_encoder(out, device="cpu")(ids, mask)
    np.testing.assert_allclose(reloaded.numpy(), jax_emb, **TOL)


# -------------------------------------------------- datasets and the CLI


def write_aligner_data(folder, n_train=16, n_dev=6, n_negatives=4):
    """A hotpotqa-style data folder: 2-hop supporting triples, hard negatives
    by title, and a comparison map marking every third question."""
    os.makedirs(folder, exist_ok=True)

    def example(i):
        a, b, c = f"w{i}", f"w{i + 60}", f"w{i + 120}"
        negs = {f"w{i + 30 + j}": [{"title": f"w{i + 30 + j}",
                                     "text": f"<w{i + 30 + j}; died; w{(i * 7 + j) % 199}>"}]
                for j in range(n_negatives)}
        return {"id": f"q{i}", "question": f"who wrote {a} ?", "answers": [c],
                "supporting_triples": [{"title": a, "text": f"<{a}; born; {b}>"},
                                       {"title": b, "text": f"<{b}; wrote; {c}>"}],
                "hard_negative_triples": negs}

    for name, rows in (("train_aligner.json", range(n_train)),
                       ("dev_aligner.json", range(n_train, n_train + n_dev))):
        with open(os.path.join(folder, name), "w") as f:
            json.dump([example(i) for i in rows], f)
    with open(os.path.join(folder, "is_comparison_map.pkl"), "wb") as f:
        pickle.dump({f"q{i}": i % 3 == 0 for i in range(n_train + n_dev)}, f)
    return str(folder)


def test_datasets_and_collator_match_jax(tmp_path):
    folder = write_aligner_data(tmp_path / "hotpotqa")
    tok = make_tokenizer(tmp_path)
    for is_train in (True, False):
        kw = dict(is_train=is_train, data_folders=[folder], num_negatives=5)
        want = JaxSeqSampleDataset(**kw)
        got = KGChainRetrieverSeqSampleDataset(**kw)
        assert got.comparison_question_ids == want.comparison_question_ids
        items = [got[i] for i in range(len(got))]
        assert items == [want[i] for i in range(len(want))]
        assert any(len(item) == 4 for item in items) != is_train  # dev: comparisons' 4 orders
        for padding in ("bucket", "max_length"):
            args = dict(query_maxlength=32, doc_maxlength=16, query_padding=padding,
                        doc_padding=padding)
            ref = JaxE5Collator(tokenizer=tok, **args)(items[:3])
            out = E5Collator(tokenizer=tok, **args)(items[:3])
            for x, y in zip(out[:2], ref[:2]):
                for key in ("input_ids", "attention_mask"):
                    np.testing.assert_array_equal(x[key], y[key])
            for x, y in zip(out[2:], ref[2:]):
                np.testing.assert_array_equal(x, y)
            for x, maxlength in zip(out[:2], (32, 16)):
                longest = int(x["attention_mask"].sum(-1).max())
                assert x["input_ids"].shape[1] == (
                    maxlength if padding == "max_length" else bucket_length(longest, maxlength))
    with pytest.raises(ValueError, match="padding"):
        RetrieverCollator(tok, 32, 32, query_padding="longest")


def run_train_cli(module, argv, monkeypatch, **kw):
    """A CLI with its TrainerConfig logging every step."""
    monkeypatch.setattr(module, "TrainerConfig",
                        functools.partial(module.TrainerConfig, log_steps=1))
    if module.__name__.startswith("kirag_tpu_torch"):
        return train_aligner.main(argv, device="cpu", **kw)
    monkeypatch.setattr(sys, "argv", ["train_aligner"] + argv)
    return jax_cli.main()


def test_cli_matches_jax(tmp_path, monkeypatch):
    """kirag_tpu.cli.train_aligner and the port's on a tiny HF checkpoint and
    a hotpotqa-style folder, f32: the same steps with the same losses, the
    same eval metric, and saved encoders with the same weights."""
    import transformers

    import kirag_tpu.training as jax_training
    import kirag_tpu_torch.training as port_training

    from tests.helpers import BASE_VOCAB, WORDS

    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(BASE_VOCAB + WORDS))
    tok = transformers.BertTokenizerFast(vocab_file=str(vocab), do_lower_case=True)
    enc_dir = save_hf_encoder(tmp_path / "e5-tiny", tok.vocab_size)
    tok.save_pretrained(enc_dir)
    folder = write_aligner_data(tmp_path / "hotpotqa")
    runs = {}
    for name, module in (("jax", jax_training), ("port", port_training)):
        argv = ["--retriever_model_name_or_path", enc_dir, "--data_folders", folder,
                "--per_device_batch_size", "4", "--num_negatives", "3", "--num_train_epochs",
                "2", "--learning_rate", "3e-4", "--compute_dtype", "float32", "--remat",
                "none", "--mesh_data", "1", "--save_dir", str(tmp_path), "--name", name]
        result = run_train_cli(module, argv, monkeypatch)
        records = [json.loads(line)
                   for line in (tmp_path / name / "metrics.jsonl").read_text().splitlines()]
        runs[name] = {"losses": [r["loss"] for r in records if "loss" in r],
                      "eval": [r["eval_metric"] for r in records if "eval_metric" in r],
                      "params": dict(np.load(tmp_path / name / "encoder" / "params.npz"))}
        assert os.listdir(tmp_path / name / "latest") == [str(len(runs[name]["losses"]))]
        if result is not None:
            assert result["steps"] == 8 and result["encoder_dir"].endswith("encoder")
    assert len(runs["port"]["losses"]) == len(runs["jax"]["losses"]) == 8
    np.testing.assert_allclose(runs["port"]["losses"], runs["jax"]["losses"], **TOL)
    np.testing.assert_allclose(runs["port"]["eval"], runs["jax"]["eval"], atol=1e-6)
    assert runs["port"]["params"].keys() == runs["jax"]["params"].keys()
    for key, value in runs["jax"]["params"].items():
        np.testing.assert_allclose(runs["port"]["params"][key], value, **TOL, err_msg=key)
