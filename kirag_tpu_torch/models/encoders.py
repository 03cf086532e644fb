"""Bi-encoders: one BERT stack, pluggable pooling heads (port of
:mod:`kirag_tpu.models.encoders`).

==========  =======================
name        pooling
==========  =======================
e5          masked mean + L2 norm
bge         CLS + L2 norm
contriever  masked mean (no norm)
==========  =======================

:meth:`Encoder.load` reads the reference's saved format (``params.npz`` +
``encoder_config.json``, written by ``kirag_tpu.models.encoders.Encoder.save``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from kirag_tpu_torch.models.bert import BertConfig, BertModel, params_from_jax
from kirag_tpu_torch.ops.pooling import cls_pool, l2_normalize, masked_mean_pool

ENCODER_POOLING: Dict[str, Dict] = {
    "e5": {"pool": masked_mean_pool, "normalize": True},
    "bge": {"pool": cls_pool, "normalize": True},
    "contriever": {"pool": masked_mean_pool, "normalize": False},
}


class Encoder:
    """(input_ids, attention_mask) -> pooled embeddings [B, H] f32 on the
    model's device. Linear weights are cast once to ``compute_dtype``;
    embeddings and LayerNorm parameters stay f32, as in the reference."""

    def __init__(self, model: BertModel, encoder_type: str = "e5",
                 compute_dtype: torch.dtype = torch.float32):
        if encoder_type not in ENCODER_POOLING:
            raise KeyError(f"{encoder_type} is not implemented! Available encoders: "
                           f"{list(ENCODER_POOLING)}")
        for m in model.modules():
            if isinstance(m, nn.Linear):
                m.to(compute_dtype)
        self.model = model.eval()
        self.config = model.config
        self.encoder_type = encoder_type
        self.compute_dtype = compute_dtype
        self.device = model.embeddings.word_embeddings.weight.device

    @property
    def embedding_size(self) -> int:
        return self.config.hidden_size

    def __call__(self, input_ids, attention_mask) -> torch.Tensor:
        ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long, device=self.device)
        mask = torch.as_tensor(np.asarray(attention_mask), dtype=torch.long,
                               device=self.device)
        with torch.inference_mode():
            hidden = self.model(ids, mask, compute_dtype=self.compute_dtype)
            head = ENCODER_POOLING[self.encoder_type]
            pooled = head["pool"](hidden.to(torch.float32), mask)
            if head["normalize"]:
                pooled = l2_normalize(pooled)
        return pooled

    @classmethod
    def from_jax(cls, params: Dict[str, Any], config: BertConfig, encoder_type: str = "e5",
                 device=None, compute_dtype: torch.dtype = torch.float32) -> "Encoder":
        """An encoder holding the JAX parameter pytree's weights."""
        model = BertModel(config, device=device)
        model.load_state_dict(params_from_jax(params, config))
        return cls(model, encoder_type, compute_dtype=compute_dtype)

    @classmethod
    def load(cls, save_dir: str, device=None,
             compute_dtype: torch.dtype = torch.float32) -> "Encoder":
        with open(os.path.join(save_dir, "encoder_config.json")) as f:
            meta = json.load(f)
        config = BertConfig(**meta["config"])
        with np.load(os.path.join(save_dir, "params.npz")) as flat:
            params = _unflatten({key: flat[key] for key in flat.files})
        return cls.from_jax(params, config, meta["encoder_type"], device=device,
                            compute_dtype=compute_dtype)


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """'/'-joined pytree paths (``layers/3/mlp/output/kernel``) -> nested
    dicts, with the numbered ``layers`` entries as a list."""
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    layers = tree.get("layers", {})
    tree["layers"] = [layers[str(i)] for i in range(len(layers))]
    return tree
