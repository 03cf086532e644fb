"""The tasks :mod:`torch_dist` runs in each gloo rank (torch and the port
only, no JAX). Each takes the pickled cases and returns what its rank saw,
as numpy, for the test process to hold against the JAX package."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from kirag_tpu_torch.parallel import (
    all_gather_cols,
    all_reduce_sum,
    broadcast,
    create_mesh,
    local_mesh_1d,
    shard_range,
    shard_rows,
)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.cpu().float().numpy() if t.dtype == torch.bfloat16 else t.cpu().numpy()
    return t


def mesh(cases):
    """The layout, the groups and the collectives of each (data, model)
    mesh in ``cases["shapes"]``; the ValueError of each in ``cases["bad"]``."""
    rank = dist.get_rank()
    out = {"rank": rank, "meshes": {}, "bad": {}}
    for data, model in cases["shapes"]:
        m = create_mesh(data, model)
        x = torch.full((2, 3), float(rank + 1))
        got = {"devices": m.devices.tolist(), "coords": m.coords, "shape": m.shape}
        for axis in ("data", "model"):
            got[axis] = {"ranks": m.group_ranks(axis), "index": m.index(axis),
                         "gather": _np(all_gather_cols(x * (1 + m.index(axis)), m, axis)),
                         "sum": _np(all_reduce_sum(x, m, axis)),
                         "bcast": _np(broadcast(x, m, axis))}
        got["bcast_all"] = _np(broadcast(x, m))
        rows = torch.arange(8 * data * 2, dtype=torch.float32).reshape(8 * data, 2)
        got["shard"] = (shard_range(8 * data, m, "data"), _np(shard_rows(rows, m, "data")))
        out["meshes"][(data, model)] = got
    out["mesh_1d"] = local_mesh_1d().shape
    for shape in cases["bad"]:
        try:
            create_mesh(*shape)
        except ValueError as e:
            out["bad"][shape] = str(e)
    return out


def search(cases):
    """Each case's sharded search on this rank's shard of ``case["corpus"]``
    on ``case.get("device", "cpu")`` (the CUDA kernels on a GPU), and on the
    first rank the unsharded search of the whole corpus: ``{"fn",
    "queries", "corpus", "scales", "scales_sharded", "k", "kw"}`` ->
    ``{"sharded": (vals, idx), "unsharded": (vals, idx) | None}``."""
    from kirag_tpu_torch import ops

    m = create_mesh()
    out = []
    for case in cases:
        dev = torch.device(case.get("device", "cpu"))
        whole = torch.as_tensor(case["corpus"]).to(dev)
        scales = case.get("scales")
        whole_scales = None if scales is None else torch.as_tensor(scales).to(dev)
        local_scales = whole_scales
        if whole_scales is not None and case.get("scales_sharded", True):
            local_scales = shard_rows(whole_scales, m)
        q, kw = torch.as_tensor(case["queries"]).to(dev), dict(case["kw"])
        fn = case["fn"]
        with_scales = fn in ("sharded_topk_mips_int8", "sharded_topk_mips_int4")

        def run(search, corpus, s, *mesh):
            if with_scales:
                return search(q, corpus, s, case["k"], *mesh, **kw)[:2]
            return search(q, corpus, case["k"], *mesh, **kw,
                          **({} if s is None else {"scales": s}))[:2]

        got = {"sharded": tuple(map(_np, run(getattr(ops, fn), shard_rows(whole, m),
                                             local_scales, m))), "unsharded": None}
        if dist.get_rank() == 0:
            got["unsharded"] = tuple(map(_np, run(getattr(ops, fn.replace("sharded_", "")),
                                                  whole, whole_scales)))
        out.append(got)
    return out


def _knn(index, queries, top, mode):
    results = index.search_knn(queries, top, mode=mode)
    return [r[0] for r in results], np.stack([r[1] for r in results])


def index(cases):
    """Each case's ``TorchIndexer(mesh=create_mesh(), **kw)`` on the CPU:
    the search results, this rank's rows on the device, the PQ codebooks,
    and with ``"serialize"`` the results of the index written by the mesh's
    first rank and read back by every rank."""
    from kirag_tpu_torch.index import TorchIndexer

    m = create_mesh()
    out = []
    for case in cases:
        ix = TorchIndexer(case["dim"], device="cpu", mesh=m, **case["kw"])
        ix.index_data([str(i) for i in range(len(case["rows"]))], case["rows"])
        if case.get("codebooks") is not None:
            ix._pq_codebooks = case["codebooks"]
        got = {"knn": _knn(ix, case["queries"], case["top"], case["mode"]),
               "corpus": _np(ix._device_corpus), "scales": _np(ix._device_scales),
               "codebooks": ix._pq_codebooks, "redispatches": ix.redispatches}
        if case.get("serialize"):
            ix.serialize(case["serialize"])
            dist.barrier()  # the first rank has written
            loaded = TorchIndexer(case["dim"], device="cpu", mesh=m)
            loaded.deserialize_from(case["serialize"])
            got["loaded"] = _knn(loaded, case["queries"], case["top"], case["mode"])
            got["loaded_compression"] = loaded.compression
        out.append(got)
    return out


def _pairs(docs):
    return [[(d["id"], d["score"]) for d in one] for one in docs]


def retriever(cases):
    """For each argv of ``cases["argvs"]``: ``cli/retrieve``'s
    ``setup_retriever_model`` over the mesh of its ``--mesh_data`` and
    ``--mesh_model`` (built by the CLI's ``build_mesh``), the retrieval of
    every question, and ``RetrievalEngine`` over that retriever: on the first
    rank the engine's documents for the questions, on the others the
    batches they followed."""
    from kirag_tpu_torch.cli.common import build_mesh
    from kirag_tpu_torch.cli.retrieve import setup_parser, setup_retriever_model
    from kirag_tpu_torch.serving import RetrievalEngine

    out = []
    for argv in cases["argvs"]:
        args = setup_parser(argv)
        mesh = build_mesh(args)
        retriever, _ = setup_retriever_model(args, device="cpu", mesh=mesh)
        docs = retriever.batch_retrieve(cases["questions"], topk=cases["topk"])
        engine = RetrievalEngine(retriever, warmup=False)  # a follower's returns at close()
        if engine.leader:
            served = _pairs(engine.search(cases["questions"], topk=cases["topk"]))
            engine.close()
        else:
            served = dict(engine.stats)
        out.append({"shape": mesh.shape, "indexer_mesh": retriever.indexer.mesh is mesh,
                    "docs": _pairs(docs), "engine": served})
    return out


class _CountingEncoder:
    """An encoder that counts its calls."""

    def __init__(self, encoder):
        self.encoder, self.calls = encoder, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.encoder(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self.encoder, name)


def _lead(engine, texts):
    """The leader's traffic: requests of two texts from six threads at once
    (top 3), lone requests trimmed below their bucket, a request that fails
    before its batch is broadcast, then one more request; ``(texts, topk,
    documents)`` each, and the failed request's error."""
    import threading

    concurrent = [(list(range(i, i + 2)), 3) for i in range(0, 12, 2)]
    results, errors = {}, []
    start = threading.Barrier(len(concurrent))

    def worker(n):
        nums, k = concurrent[n]
        start.wait()
        try:
            results[n] = engine.search([texts[i] for i in nums], topk=k)
        except Exception as e:  # reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(n,)) for n in range(len(concurrent))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"concurrent requests failed: {errors}")
    served = [(nums, k, _pairs(results[n])) for n, (nums, k) in enumerate(concurrent)]
    for nums, k in ((list(range(12, 15)), 2), (list(range(15, 17)), 4)):
        served.append((nums, k, _pairs(engine.search([texts[i] for i in nums], topk=k))))
    try:
        engine.search([], topk=3)
        failed = None
    except ValueError as e:
        failed = str(e)
    nums = list(range(17, 20))
    served.append((nums, 5, _pairs(engine.search([texts[i] for i in nums], topk=5))))
    return served, failed


def engine(cases):
    """``RetrievalEngine`` over ``TorchIndexer(mesh=create_mesh(*cases["mesh"]))``
    on the CPU, one engine a ``cases["variants"]`` entry ``(compression,
    mode)``: the tiny E5 of ``cases["tree"]`` (converted by
    ``Encoder.from_jax``) over the rows and ids given. The first rank
    serves :func:`_lead`'s traffic and closes; each other rank's constructor
    follows until then, and its ``search()`` must raise. With
    ``cases["fail"]`` an engine's indexer raises inside the first batch's
    search on every rank: the errors each rank saw (the leader's for that
    request and the next); then the leader's encoder raises in the warm-up:
    what each rank's constructor raised."""
    import transformers

    from kirag_tpu_torch.data import E5Collator
    from kirag_tpu_torch.index import TorchIndexer
    from kirag_tpu_torch.models import BertConfig, Encoder
    from kirag_tpu_torch.retrieval import DenseRetriever
    from kirag_tpu_torch.serving import RetrievalEngine

    tok = transformers.BertTokenizerFast(vocab_file=cases["vocab"], do_lower_case=True)
    mesh = create_mesh(*cases["mesh"])
    encoder = _CountingEncoder(Encoder.from_jax(cases["tree"], BertConfig(**cases["cfg"]),
                                                "e5", device="cpu"))
    collator = E5Collator(tok, 64, 64)

    def served_engine(compression, mode):
        ix = TorchIndexer(cases["dim"], device="cpu", exact_impl="kernel",
                          pallas_chunk_size=2048, compression=compression, approx_winners=1,
                          mesh=mesh)
        ix.index_data(cases["ids"], cases["rows"])
        ret = DenseRetriever(encoder, collator, indexer=ix, batch_size=4, search_mode=mode)
        return ret, lambda: RetrievalEngine(ret, max_batch=16, max_wait_ms=100,
                                            topk_buckets=(3, 5))

    out = {"rank": dist.get_rank(), "variants": {}}
    for compression, mode in cases["variants"]:
        encoder.calls = 0
        _, make = served_engine(compression, mode)
        eng = make()  # a follower's returns once the leader has closed
        got = {}
        if eng.leader:
            got["served"], got["failed"] = _lead(eng, cases["texts"])
            eng.close()
            eng.close()  # a second close does nothing
        else:
            try:
                eng.search(cases["texts"][:1], topk=3)
            except RuntimeError as e:
                got["follower_search"] = str(e)
        got["stats"], got["encoded"] = dict(eng.stats), encoder.calls
        out["variants"][(compression, mode)] = got
    if cases.get("fail"):
        ret, make = served_engine("none", "exact")
        searches = {"n": 0}
        run = ret.indexer._run_mips

        def failing(*args, **kwargs):  # the search's own error, on every rank
            searches["n"] += 1
            if searches["n"] == 3:  # the first batch after the warm-up's two
                raise RuntimeError(f"search failed on rank {dist.get_rank()}")
            return run(*args, **kwargs)

        ret.indexer._run_mips = failing
        try:
            eng = make()
        except RuntimeError as e:  # a follower
            out["fail"] = [str(e)]
        else:
            out["fail"] = []
            for _ in range(2):
                try:
                    eng.search(cases["texts"][:1], topk=3)
                    out["fail"].append(None)
                except RuntimeError as e:
                    out["fail"].append(str(e))
            eng.close()
        # a warm-up that fails before its first broadcast (the leader's
        # encoder): the leader raises, and the followers get the abort
        ret, make = served_engine("none", "exact")
        if dist.get_rank() == 0:
            def broken(*args, **kwargs):
                raise RuntimeError("encoder failed on rank 0")

            ret.encoder = broken
        try:
            make()
            out["abort"] = "constructed"
        except RuntimeError as e:
            out["abort"] = str(e)
    return out


def llm(cases):
    """Each case's ``TorchLlamaBackend(...).shard_params(create_mesh(*mesh))``
    on the CPU at f32 compute: greedy ids and logits over the sharded params
    (or a speculative decode with a sharded draft), and this rank's bytes."""
    from kirag_tpu_torch.models import llm as port_llm
    from kirag_tpu_torch.models.speculative import speculative_decode

    out = []
    for case in cases:
        config = port_llm.LlamaConfig(**case["config"])
        params = port_llm.llama_params_from_jax(case["tree"], device="cpu")
        draft = {}
        if case.get("draft") is not None:
            d_config = port_llm.LlamaConfig(**case["draft_config"])
            draft = dict(draft_params=port_llm.llama_params_from_jax(case["draft"], device="cpu"),
                         draft_config=d_config, spec_gamma=3)
        backend = port_llm.TorchLlamaBackend(params, config, eos_token_id=2,
                                             compute_dtype=torch.float32, **draft)
        whole = port_llm.param_bytes(backend.params)
        backend.shard_params(create_mesh(*case["mesh"]))
        got = {"bytes": (whole, port_llm.param_bytes(backend.params))}
        if draft:
            ids, _ = speculative_decode(backend.params, config, backend.draft_params,
                                        draft["draft_config"], case["ids"], case["mask"],
                                        case["steps"], gamma=3, compute_dtype=torch.float32,
                                        return_logits=False)
            got["ids"] = _np(ids)
        else:
            ids, logits = port_llm.greedy_decode(backend.params, case["ids"], case["mask"],
                                                 config, case["steps"])
            got["ids"], got["logits"] = _np(ids), _np(logits)
        out.append(got)
    return out


def _bert(case):
    """The case's model on ``case.get("device", "cpu")``."""
    from kirag_tpu_torch.models import BertConfig, BertModel, params_from_jax

    config = BertConfig(**case["cfg"])
    model = BertModel(config, device=case.get("device", "cpu"))
    model.load_state_dict(params_from_jax(case["tree"], config))
    return model


def _param_bytes(model):
    return sum(p.numel() * p.element_size() for p in model.parameters())


def bert_tp(cases):
    """Each case's ``Encoder(...).shard_params(create_mesh(*mesh))`` on its
    device (default the CPU) at its compute dtype (default f32): the
    embeddings of ``ids``/``mask``, the whole and this rank's parameter
    bytes and each parameter's local shape; a model axis that cannot shard
    the model returns the ValueError's text instead (``"refused"``)."""
    from kirag_tpu_torch.models import Encoder

    out = []
    for case in cases:
        model = _bert(case)
        encoder = Encoder(model, case.get("encoder_type", "e5"),
                          compute_dtype=case.get("dtype", torch.float32))
        whole = _param_bytes(encoder.model)
        try:
            encoder.shard_params(create_mesh(*case["mesh"]))
        except ValueError as e:
            out.append({"refused": str(e)})
            continue
        emb = encoder(case["ids"], case["mask"])
        out.append({"emb": _np(emb), "bytes": (whole, _param_bytes(encoder.model)),
                    "shapes": {n: tuple(p.shape) for n, p in encoder.model.named_parameters()},
                    "caller_untouched": all(p.shape == q.shape for p, q in zip(
                        model.parameters(), _bert(case).parameters()))})
    return out


def _first(batch):
    return batch[0]


def _aligner_trainer(case, mesh, save_dir, model=None):
    from kirag_tpu_torch.training import AlignerTrainer, DataLoader, TrainerConfig

    kw = dict(learning_rate=3e-4, num_train_epochs=1, eval_steps=1000, log_steps=1000)
    kw.update(case.get("tcfg", {}))
    loader = DataLoader(case["batches"], batch_size=1, shuffle=False, collate_fn=_first)
    evals = case.get("eval")
    return AlignerTrainer(
        model if model is not None else _bert(case), TrainerConfig(save_dir=save_dir, **kw),
        loader, None if evals is None else DataLoader(evals, batch_size=1, shuffle=False,
                                                      collate_fn=_first),
        temperature=0.05, mesh=mesh, batch_sharding=case.get("batch_sharding", "data"),
        remat=case.get("remat", False), packed=case.get("packed", False),
        compute_dtype=case.get("dtype", torch.float32))


def _jax_flat(trainer, tensors):
    """Whole-model tensors by parameter name -> the reference's flat layout
    (copies: a later step does not change them)."""
    from kirag_tpu_torch.models.encoders import _jax_flat_state

    return {k: v.copy() for k, v in _jax_flat_state(tensors, trainer.model.config).items()}


def _whole_params(trainer):
    from kirag_tpu_torch.models.bert import gather_state_dict

    return _jax_flat(trainer, gather_state_dict(trainer.model))


def _record_grads(trainer):
    """Wrap the optimizer's update so that each micro step's gradients, as
    the whole model's and summed over the data axis, are kept."""
    seen = []
    update = trainer.optimizer.update

    def recording(grads):
        whole = {}
        for name, g in zip(trainer.names, grads):
            if trainer.batch_sharding is not None:
                g = all_reduce_sum(g, trainer.mesh, trainer.batch_sharding)
            whole[name] = trainer._whole(name, g)
        seen.append(_jax_flat(trainer, whole))
        return update(grads)

    trainer.optimizer.update = recording
    return seen


def _steps(trainer, n):
    return [trainer.training_step(trainer.train_loader.dataset[i]) for i in range(n)]


def aligner(cases):
    """Each case's ``AlignerTrainer(mesh=create_mesh(*mesh), batch_sharding=)``
    on its device (default the CPU), by ``case["op"]``:

    - ``"step"``: ``steps`` micro steps: their statistics, the first step's
      gradients (summed over the data axis, gathered over the model axis,
      in the reference's layout), the parameters after, this rank's bytes,
      the kernels' launches in the steps; with ``"eval"`` the trainer's
      ``evaluate`` and ``evaluate_corpus_mrr`` before the steps; with
      ``"save_encoder"`` the encoder written there; with ``"checkpoint"``
      the trainer's checkpoint saved after the steps;
    - ``"resume"``: two steps with a checkpoint after the first, then a new
      trainer resumed from it on the same mesh: both second steps' losses
      and parameters;
    - ``"load"``: a trainer resumed from ``case["from"]`` (a checkpoint of
      another layout), one step: its statistics and parameters;
    - ``"nonfinite"``: one step whose gradient of a (model-sharded) weight
      is NaN on the last rank only: every rank's parameters and skip
      counters;
    - ``"rows"``: the ValueError of a batch whose rows do not divide the
      data axis;
    - ``"writes"``: ``train()`` with each rank in its own directory: the
      files each rank wrote."""
    import os

    out = []
    for case in cases:
        m = create_mesh(*case["mesh"])
        save_dir = case["save_dir"]
        op = case["op"]
        if op == "writes":
            save_dir = os.path.join(save_dir, str(dist.get_rank()))
        trainer = _aligner_trainer(case, m, save_dir)
        got = {"bytes": _param_bytes(trainer.model)}
        if op == "step":
            from kirag_tpu_torch.kernels import launch_counts, reset_launch_counts

            if case.get("eval") is not None:
                got["eval"] = (trainer.evaluate(trainer.model, trainer.eval_loader),
                               trainer.evaluate_corpus_mrr(trainer.model, trainer.eval_loader))
            seen = _record_grads(trainer)
            reset_launch_counts()
            got["stats"] = _steps(trainer, case.get("steps", 1))
            got["launches"] = dict(launch_counts())
            got["grads"] = seen[0]
            got["params"] = _whole_params(trainer)
            if case.get("save_encoder"):
                trainer.save_encoder(case["save_encoder"])
            if case.get("checkpoint"):
                trainer.save_checkpoint()
        elif op == "resume":
            first = _steps(trainer, 1)
            trainer.save_checkpoint()
            second = trainer.training_step(trainer.train_loader.dataset[1])
            got["uninterrupted"] = (second, _whole_params(trainer))
            again = _aligner_trainer(case, m, save_dir)
            assert again.resume_training() and again.step == 1
            resumed = again.training_step(again.train_loader.dataset[1])
            got["resumed"] = (resumed, _whole_params(again))
            got["first"] = first[0]
        elif op == "load":
            trainer.latest.root = os.path.join(case["from"], "latest")
            assert trainer.resume_training()
            got["loaded"] = _whole_params(trainer)
            got["stats"] = _steps(trainer, 1)
            got["params"] = _whole_params(trainer)
        elif op == "nonfinite":
            update = trainer.optimizer.update
            sharded = trainer.names.index("layers.1.mlp.intermediate.weight")

            def poisoned(grads):
                if dist.get_rank() == dist.get_world_size() - 1:
                    grads = list(grads)
                    grads[sharded] = grads[sharded] * float("nan")
                return update(grads)

            before = _whole_params(trainer)
            trainer.optimizer.update = poisoned
            got["stats"] = _steps(trainer, 1)
            after = _whole_params(trainer)
            got["unchanged"] = all(np.array_equal(before[k], after[k]) for k in before)
            got["skips"] = (trainer.optimizer.notfinite_count,
                            trainer.optimizer.total_notfinite, trainer.optimizer.count)
        elif op == "rows":
            try:
                trainer.device_put_batch(trainer.pack_batch(case["batches"][0]))
                got["error"] = None
            except ValueError as e:
                got["error"] = str(e)
        elif op == "writes":
            trainer.train()
            got["files"] = sorted(os.path.relpath(os.path.join(d, f), save_dir)
                                  for d, _, fs in os.walk(save_dir) for f in fs)
            got["history"] = len(trainer.history)
        out.append(got)
    return out


class WordTokenizer:
    """A word-level stand-in for a HuggingFace tokenizer, so that the ranks
    need not import transformers (about 12 s a process): lower-cased words
    and punctuation looked up in ``vocab`` ([UNK] otherwise), [CLS] ...
    [SEP], right padding with 0; called as the collators call a HF
    tokenizer."""

    def __init__(self, vocab):
        self.ids = {w: i for i, w in enumerate(vocab)}
        self.padding_side = "right"

    def __call__(self, texts, max_length, padding="max_length", truncation=True,
                 return_tensors="np"):
        import re

        ids = np.zeros((len(texts), max_length), dtype=np.int64)
        mask = np.zeros_like(ids)
        for i, text in enumerate(texts):
            words = re.findall(r"\w+|[^\w\s]", text.lower())[:max_length - 2]
            row = ([self.ids["[CLS]"]] + [self.ids.get(w, self.ids["[UNK]"]) for w in words]
                   + [self.ids["[SEP]"]])
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def cli(cases):
    """Each case's CLI ``main(argv, device="cpu", tokenizer=WordTokenizer(
    case["vocab"]))`` under the mesh its ``--mesh_data``/``--mesh_model``
    build over the ranks (``train_aligner`` logs every step): what it
    returned, and the files this rank's run left under ``case["root"]`` that
    were not there before."""
    import functools
    import os

    import kirag_tpu_torch.training as training
    from kirag_tpu_torch.cli import compute_corpus_embeddings, train_aligner

    training.TrainerConfig = functools.partial(training.TrainerConfig, log_steps=1)
    out = []
    for case in cases:
        def files():
            return {os.path.join(d, f) for d, _, fs in os.walk(case["root"]) for f in fs}

        dist.barrier()
        before = files()
        module = {"train_aligner": train_aligner,
                  "compute_corpus_embeddings": compute_corpus_embeddings}[case["cli"]]
        result = module.main(case["argv"], device="cpu", tokenizer=WordTokenizer(case["vocab"]))
        dist.barrier()
        out.append({"result": result, "new_files": sorted(files() - before)})
    return out


def dryrun(cases):
    """``parallel.dryrun.dryrun_multichip`` on the CPU over every rank: its
    summary line."""
    from kirag_tpu_torch.parallel.dryrun import dryrun_multichip

    return [dryrun_multichip("cpu", work_dir=case.get("work")) for case in cases]
