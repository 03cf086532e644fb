"""Reasoning Chain Aligner training: the in-batch contrastive bi-encoder
(port of :mod:`kirag_tpu.training.aligner`).

Queries and (1 positive + N negative) triple texts are embedded by the
shared encoder, scored ``q . d / temperature`` over the whole batch, and
trained with cross-entropy against each query's positive column. The
encoder is an f32 :class:`~kirag_tpu_torch.models.bert.BertModel` run in the
compute dtype: its linear layers cast their f32 weights per call, so the
gradients reach f32 master weights. On the card, every encoder layer whose
sequence length is a multiple of 128 goes through the flash attention
kernels, forward and backward.

Over a mesh (:class:`AlignerTrainer` ``mesh=``), a batch sharded over the
data axis is embedded rank by rank and the embeddings (and the positives'
indices) are gathered over that axis with
:func:`~kirag_tpu_torch.parallel.mesh.all_gather_rows` before the score
matrix, so every rank computes the loss over the global [num_queries,
num_docs] matrix, as the reference's GSPMD program does; a model axis of
more than one rank shards the encoder (:func:`~kirag_tpu_torch.models.bert.
shard_bert_model`).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from kirag_tpu_torch.models.bert import (
    BertModel,
    bert_encode,
    gather_state_dict,
    shard_bert_model,
)
from kirag_tpu_torch.models.encoders import ENCODER_POOLING, save_encoder_state
from kirag_tpu_torch.ops.pooling import l2_normalize
from kirag_tpu_torch.parallel.mesh import all_gather_rows
from kirag_tpu_torch.training.trainer import BaseTrainer, TrainerConfig


def _embed(model: BertModel, args: Dict[str, torch.Tensor], encoder_type: str,
           compute_dtype: torch.dtype) -> torch.Tensor:
    hidden = bert_encode(model, args["input_ids"], args["attention_mask"],
                         compute_dtype=compute_dtype)
    head = ENCODER_POOLING[encoder_type]
    pooled = head["pool"](hidden.to(torch.float32), args["attention_mask"])
    return l2_normalize(pooled) if head["normalize"] else pooled


def _embed_packed(model: BertModel, query_args: Dict[str, torch.Tensor],
                  doc_args: Dict[str, torch.Tensor], encoder_type: str,
                  compute_dtype: torch.dtype):
    """Queries and docs in ONE encoder forward by sequence packing.

    ``q_len // d_len`` docs share each packed row: positions restart per doc
    and attention stays within each doc (segment ids; segment 0 is padding),
    so each doc's result is the two-call form's while the matmuls run at a
    larger batch. Needs ``q_len % d_len == 0`` and ``num_docs % (q_len //
    d_len) == 0`` (:func:`_can_pack`).
    """
    q_ids, q_mask = query_args["input_ids"], query_args["attention_mask"]
    d_ids, d_mask = doc_args["input_ids"], doc_args["attention_mask"]
    bq, lq = q_ids.shape
    bd, ld = d_ids.shape
    r = lq // ld
    rows = bd // r
    device = q_ids.device
    ids = torch.cat([q_ids, d_ids.reshape(rows, r * ld)])
    mask = torch.cat([q_mask, d_mask.reshape(rows, r * ld)])
    pos = torch.cat([torch.arange(lq, device=device).expand(bq, lq),
                     torch.arange(ld, device=device).repeat(r).expand(rows, r * ld)])
    # doc s of a packed row gets segment s + 1; query rows are one segment
    seg_d = d_mask.reshape(rows, r, ld) * (1 + torch.arange(r, device=device))[None, :, None]
    seg = torch.cat([q_mask, seg_d.reshape(rows, r * ld)])
    hidden = bert_encode(model, ids, mask, compute_dtype=compute_dtype, position_ids=pos,
                         segment_ids=seg)
    pool = ENCODER_POOLING[encoder_type]["pool"]
    q_emb = pool(hidden[:bq].to(torch.float32), q_mask)
    d_emb = pool(hidden[bq:].reshape(bd, ld, -1).to(torch.float32), d_mask)
    if ENCODER_POOLING[encoder_type]["normalize"]:
        q_emb, d_emb = l2_normalize(q_emb), l2_normalize(d_emb)
    return q_emb, d_emb


def _can_pack(batch) -> bool:
    bq, lq = batch["query_args"]["input_ids"].shape
    bd, ld = batch["doc_args"]["input_ids"].shape
    return ld > 0 and lq % ld == 0 and bd % (lq // ld) == 0


# the matrix products whose outputs remat="dots" keeps (JAX's dots_saveable)
_MATMULS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default}


def _save_matmuls(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _MATMULS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, remat):
    """``fn`` itself (``remat`` False), under activation checkpointing
    (True: everything recomputed in the backward), or under selective
    checkpointing that keeps the matmul outputs ("dots")."""
    if not remat:
        return fn
    if remat == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts, _save_matmuls)
        return functools.partial(checkpoint, fn, use_reentrant=False, context_fn=context_fn)
    return functools.partial(checkpoint, fn, use_reentrant=False)


def _gather(mesh, axis: Optional[str], *tensors):
    """Each tensor's rows of every rank along ``axis``, in rank order
    (differentiable); the tensors themselves without an axis."""
    if axis is None:
        return tensors
    return tuple(all_gather_rows(t, mesh, axis) for t in tensors)


def in_batch_contrastive_loss(model: BertModel, batch, encoder_type: str = "e5",
                              temperature: float = 0.01,
                              compute_dtype: torch.dtype = torch.float32, remat=False,
                              packed: bool = False, mesh=None, data_axis: Optional[str] = None):
    """CE over the global [num_queries, num_docs] score matrix; returns
    (loss, {"accuracy": ...}).

    ``batch`` = {"query_args", "doc_args", "positive_doc_indices"} of tensors
    on the model's device (the training collator's output). ``remat``:
    False, True (full recomputation of each embed call in the backward) or
    "dots" (matmul outputs kept, the rest recomputed, the flash attention
    forward included: it is deterministic); all three give the same
    gradients. ``packed`` runs queries and docs through one encoder forward
    (:func:`_embed_packed`) when the geometry packs, else the two-call form.
    ``data_axis``: the axis of ``mesh`` that the batch's rows are sharded
    over; the embeddings and labels are gathered over it first.
    """
    if packed and _can_pack(batch):
        q_emb, d_emb = _remat(_embed_packed, remat)(
            model, batch["query_args"], batch["doc_args"], encoder_type, compute_dtype)
    else:
        embed = _remat(_embed, remat)
        q_emb = embed(model, batch["query_args"], encoder_type, compute_dtype)
        d_emb = embed(model, batch["doc_args"], encoder_type, compute_dtype)
    q_emb, d_emb, labels = _gather(mesh, data_axis, q_emb, d_emb,
                                   batch["positive_doc_indices"])
    scores = (q_emb @ d_emb.T) / temperature
    log_probs = F.log_softmax(scores, dim=-1)
    loss = -torch.mean(torch.gather(log_probs, 1, labels[:, None]))
    acc = torch.mean((torch.argmax(scores, dim=-1) == labels).to(torch.float32))
    return loss, {"accuracy": acc}


class AlignerTrainer(BaseTrainer):
    """Trains the aligner encoder; evaluates per-query MRR over each query's
    own positive + negative candidates.

    ``mesh`` / ``batch_sharding`` (an axis name such as ``"data"``, or None
    for a replicated batch): see :mod:`kirag_tpu_torch.training.trainer`.
    Where ``mesh.shape["model"] > 1`` the trainer trains a rank-local copy
    of ``model`` sharded over the model axis (``model`` itself is left as it
    is); otherwise it trains ``model`` in place."""

    def __init__(self, model: BertModel, config: TrainerConfig, train_loader,
                 eval_loader=None, encoder_type: str = "e5", temperature: float = 0.01,
                 compute_dtype: torch.dtype = torch.float32,
                 num_candidates_per_query: Optional[int] = None, remat=False,
                 packed: bool = False, trackers=(), mesh=None,
                 batch_sharding: Optional[str] = None):
        self.encoder_type = encoder_type
        self.temperature = temperature
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.packed = packed
        self.num_candidates_per_query = num_candidates_per_query
        if mesh is not None and mesh.shape.get("model", 1) > 1:
            model = shard_bert_model(model, mesh)
        super().__init__(model, config, train_loader, eval_loader, trackers=trackers,
                         mesh=mesh, batch_sharding=batch_sharding)

    @staticmethod
    def pack_batch(collated) -> Dict:
        """The collator's tuple as the loss's dict."""
        query_args, doc_args, positive_doc_indices, index = collated
        return {
            "query_args": query_args,
            "doc_args": doc_args,
            "positive_doc_indices": positive_doc_indices,
            "index": index,
        }

    def loss_fn(self, model, batch):
        return in_batch_contrastive_loss(
            model, batch, self.encoder_type, self.temperature, self.compute_dtype,
            remat=self.remat, packed=self.packed, mesh=self.mesh,
            data_axis=self.batch_sharding)

    @torch.no_grad()
    def _embed_pair(self, model, batch):
        """The batch's (query, doc) embeddings, gathered over the data axis
        of a sharded batch."""
        return _gather(self.mesh, self.batch_sharding,
                       _embed(model, batch["query_args"], self.encoder_type,
                              self.compute_dtype),
                       _embed(model, batch["doc_args"], self.encoder_type, self.compute_dtype))

    def _positives(self, batch) -> np.ndarray:
        """The batch's positive_doc_indices, gathered as the embeddings are."""
        return _gather(self.mesh, self.batch_sharding,
                       batch["positive_doc_indices"])[0].cpu().numpy()

    def _score_batch(self, model, batch) -> torch.Tensor:
        q_emb, d_emb = self._embed_pair(model, batch)
        return q_emb @ d_emb.T

    def evaluate(self, model, eval_loader) -> float:
        """Mean reciprocal rank of each query's positive among its OWN
        candidate block [pos, neg_1..neg_k]."""
        rr = []
        for collated in eval_loader:
            batch = self.device_put_batch(self.pack_batch(collated))
            scores = self._score_batch(model, batch).cpu().numpy()
            pos_idx = self._positives(batch)
            n_q = len(pos_idx)
            n_docs = scores.shape[1]
            for i in range(n_q):
                start = int(pos_idx[i])
                end = int(pos_idx[i + 1]) if i + 1 < n_q else n_docs
                block = scores[i, start:end]
                rank = 1 + int(np.sum(block > block[0]))
                rr.append(1.0 / rank)
        return float(np.mean(rr)) if rr else 0.0

    def training_step(self, collated):
        return super().training_step(self.pack_batch(collated))

    def evaluate_corpus_mrr(self, model, eval_loader, max_docs: Optional[int] = None) -> float:
        """Corpus-wide MRR: each query's positive ranked against ALL candidate
        docs of the eval set, harder than :meth:`evaluate`'s blocks."""
        q_embs, d_embs, pos_global = [], [], []
        offset = 0
        for collated in eval_loader:
            batch = self.device_put_batch(self.pack_batch(collated))
            q, d = (x.cpu().numpy() for x in self._embed_pair(model, batch))
            q_embs.append(q)
            d_embs.append(d)
            pos_global.extend((self._positives(batch) + offset).tolist())
            offset += len(d)
            if max_docs and offset >= max_docs:
                break
        scores = np.concatenate(q_embs) @ np.concatenate(d_embs).T
        rr = []
        for i, pos in enumerate(pos_global):
            rank = 1 + int(np.sum(scores[i] > scores[i, pos]))
            rr.append(1.0 / rank)
        return float(np.mean(rr)) if rr else 0.0

    def save_encoder(self, save_dir: str) -> None:
        """Write the trained encoder in the reference's npz format
        (:meth:`Encoder.save`), which ``load_encoder`` of either package
        reads, e.g. as the KiRAG CLI's ``--aligner_model_name_or_path``.
        Over a mesh the whole model is gathered and the first rank writes;
        every rank returns once the files are there."""
        save_encoder_state(save_dir, gather_state_dict(self.model), self.model.config,
                           self.encoder_type, writer=self.writer)
        self.barrier()
