"""Bi-encoders: one BERT stack, pluggable pooling heads (port of
:mod:`kirag_tpu.models.encoders`).

==========  =======================
name        pooling
==========  =======================
e5          masked mean + L2 norm
bge         CLS + L2 norm
contriever  masked mean (no norm)
==========  =======================

:func:`load_encoder` reads the reference's saved format (``params.npz`` +
``encoder_config.json``, written by ``kirag_tpu.models.encoders.Encoder.save``)
or an HF checkpoint directory (``config.json`` + ``model.safetensors`` or
``pytorch_model.bin``). Its entry points (:meth:`Encoder.from_jax`,
:meth:`Encoder.load`, :func:`load_encoder`) build the model on the GPU
unless the caller passes ``device="cpu"``. :meth:`Encoder.shard_params`
shards the weights over a mesh's model axis (tensor parallelism, for
inference); every rank then returns the same embeddings.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from kirag_tpu_torch.device import require_cuda
from kirag_tpu_torch.models.bert import (
    BertConfig,
    BertModel,
    config_from_hf,
    convert_hf_state_dict,
    gather_state_dict,
    params_from_jax,
    shard_bert_model,
)
from kirag_tpu_torch.models.registry import resolve_model_path
from kirag_tpu_torch.ops.pooling import cls_pool, l2_normalize, masked_mean_pool
from kirag_tpu_torch.utils.io import load_json

ENCODER_POOLING: Dict[str, Dict] = {
    "e5": {"pool": masked_mean_pool, "normalize": True},
    "bge": {"pool": cls_pool, "normalize": True},
    "contriever": {"pool": masked_mean_pool, "normalize": False},
}

# retriever-name aliases of the CLI
RETRIEVER_NAME_TO_ENCODER = {
    "E5Retriever": "e5",
    "BGERetriever": "bge",
    "ContrieverRetriever": "contriever",
}


def _entry_device(device) -> torch.device:
    """An entry point's device: the GPU unless the caller names one."""
    return require_cuda() if device is None else torch.device(device)


class Encoder:
    """(input_ids, attention_mask) -> pooled embeddings [B, H] f32 on the
    model's device. Linear weights are cast once to ``compute_dtype``;
    embeddings and LayerNorm parameters stay f32, as in the reference.
    ``attention_impl``: "auto", "flash" or "xla" (see
    :mod:`kirag_tpu_torch.models.bert`)."""

    def __init__(self, model: BertModel, encoder_type: str = "e5",
                 compute_dtype: torch.dtype = torch.float32, attention_impl: str = "auto"):
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
        self.attention_impl = attention_impl
        self.device = model.embeddings.word_embeddings.weight.device

    @property
    def embedding_size(self) -> int:
        return self.config.hidden_size

    def __call__(self, input_ids, attention_mask) -> torch.Tensor:
        ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long, device=self.device)
        mask = torch.as_tensor(np.asarray(attention_mask), dtype=torch.long,
                               device=self.device)
        with torch.inference_mode():
            hidden = self.model(ids, mask, compute_dtype=self.compute_dtype,
                                attention_impl=self.attention_impl)
            head = ENCODER_POOLING[self.encoder_type]
            pooled = head["pool"](hidden.to(torch.float32), mask)
            if head["normalize"]:
                pooled = l2_normalize(pooled)
        return pooled

    @classmethod
    def from_jax(cls, params: Dict[str, Any], config: BertConfig, encoder_type: str = "e5",
                 device=None, compute_dtype: torch.dtype = torch.float32,
                 attention_impl: str = "auto") -> "Encoder":
        """An encoder holding the JAX parameter pytree's weights, on ``device``
        (default: the GPU)."""
        model = BertModel(config, device=_entry_device(device))
        model.load_state_dict(params_from_jax(params, config))
        return cls(model, encoder_type, compute_dtype=compute_dtype,
                   attention_impl=attention_impl)

    def shard_params(self, mesh, model_axis: str = "model") -> "Encoder":
        """Keep this rank's shard of the weights over ``mesh[model_axis]``
        (:func:`~kirag_tpu_torch.models.bert.shard_bert_model`; port of the
        reference's ``Encoder.shard_params``). Every later call is a
        collective of that axis: each of its ranks calls it with the same
        inputs and gets the same [B, H] embeddings."""
        self.model = shard_bert_model(self.model, mesh, model_axis).eval()
        return self

    def save(self, save_dir: str) -> None:
        """Write ``params.npz`` (f32, the reference's '/'-joined pytree paths)
        and ``encoder_config.json``: the format of the reference's
        ``Encoder.save``, which its ``Encoder.load`` reads. A sharded model
        is gathered (a collective of its model axis) and written by its
        mesh's first rank only."""
        save_encoder_state(save_dir, gather_state_dict(self.model), self.config,
                           self.encoder_type, writer=_first_rank(self.model))

    @classmethod
    def load(cls, save_dir: str, device=None, compute_dtype: torch.dtype = torch.float32,
             attention_impl: str = "auto") -> "Encoder":
        """An encoder saved by the reference's ``Encoder.save``, on ``device``
        (default: the GPU)."""
        meta = load_json(os.path.join(save_dir, "encoder_config.json"))
        config = BertConfig(**meta["config"])
        device = _entry_device(device)
        with np.load(os.path.join(save_dir, "params.npz")) as flat:
            params = _unflatten({key: flat[key] for key in flat.files})
        return cls.from_jax(params, config, meta["encoder_type"], device=device,
                            compute_dtype=compute_dtype, attention_impl=attention_impl)


def load_encoder(model_name_or_path: str, encoder_type: str = "e5",
                 compute_dtype: torch.dtype = torch.float32, device=None,
                 attention_impl: str = "auto") -> Encoder:
    """Load an encoder, on ``device`` (default: the GPU), from

    1. the reference's npz format (``encoder_config.json`` present; its
       ``encoder_type`` wins), or
    2. an HF directory: ``config.json`` + ``model.safetensors`` or
       ``pytorch_model.bin``.

    A name that is not a directory is resolved by
    :func:`~kirag_tpu_torch.models.registry.resolve_model_path`.
    """
    if not os.path.isdir(model_name_or_path):
        model_name_or_path = resolve_model_path(model_name_or_path)
    device = _entry_device(device)
    if os.path.exists(os.path.join(model_name_or_path, "encoder_config.json")):
        return Encoder.load(model_name_or_path, device=device, compute_dtype=compute_dtype,
                            attention_impl=attention_impl)
    config = config_from_hf(load_json(os.path.join(model_name_or_path, "config.json")))
    st_path = os.path.join(model_name_or_path, "model.safetensors")
    bin_path = os.path.join(model_name_or_path, "pytorch_model.bin")
    if os.path.exists(st_path):
        state_dict = read_safetensors(st_path)
    elif os.path.exists(bin_path):
        state_dict = torch.load(bin_path, map_location="cpu", weights_only=True)
    else:
        raise FileNotFoundError(f"no model.safetensors or pytorch_model.bin under "
                                f"{model_name_or_path}")
    model = BertModel(config, device=device)
    model.load_state_dict(convert_hf_state_dict(state_dict, config))
    return Encoder(model, encoder_type, compute_dtype=compute_dtype,
                   attention_impl=attention_impl)


_SAFETENSORS_DTYPES = {"F32": np.dtype("<f4"), "F16": np.dtype("<f2"), "BF16": np.dtype("<u2")}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a ``.safetensors`` file as f32 CPU tensors, read without
    the ``safetensors`` package: an 8-byte little-endian header length, a JSON
    header of ``{name: {dtype, shape, data_offsets}}``, then the raw
    little-endian bytes (offsets count from the end of the header). F32, F16
    and BF16 are read; other dtypes raise."""
    with open(path, "rb") as f:
        (n_header,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n_header))
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n_header)
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise TypeError(f"{path}: tensor {name} has dtype {info['dtype']}; "
                            f"only {sorted(_SAFETENSORS_DTYPES)} are read")
        start, end = info["data_offsets"]
        raw = data[start:end].view(dtype).reshape(info["shape"])
        if info["dtype"] == "BF16":  # bf16 is the upper half of an f32
            raw = (raw.astype(np.uint32) << 16).view(np.float32)
        out[name] = torch.from_numpy(raw.astype(np.float32))
    return out


def _first_rank(model: BertModel) -> bool:
    return model.tp is None or model.tp.mesh.rank == 0


def save_encoder_state(save_dir: str, state_dict: Dict[str, torch.Tensor], config: BertConfig,
                       encoder_type: str, writer: bool = True) -> None:
    """:meth:`Encoder.save`'s files for a whole model's ``state_dict``;
    nothing unless ``writer``."""
    if not writer:
        return
    os.makedirs(save_dir, exist_ok=True)
    np.savez(os.path.join(save_dir, "params.npz"), **_jax_flat_state(state_dict, config))
    with open(os.path.join(save_dir, "encoder_config.json"), "w") as f:
        json.dump({"encoder_type": encoder_type, "config": dataclasses.asdict(config)}, f,
                  indent=2)


def _jax_flat_params(model: BertModel) -> Dict[str, np.ndarray]:
    """:func:`_jax_flat_state` of an unsharded model."""
    return _jax_flat_state(model.state_dict(), model.config)


def _jax_flat_state(state_dict: Dict[str, torch.Tensor],
                    config: BertConfig) -> Dict[str, np.ndarray]:
    """The inverse of ``params_from_jax``, flattened to '/'-joined paths:
    ``nn.Linear`` [out, in] weights become [in, out] kernels and a fused
    ``qkv`` is split into query, key and value."""
    sd = {k: v.detach().float().cpu().numpy() for k, v in state_dict.items()}
    h = config.hidden_size
    flat: Dict[str, np.ndarray] = {}

    def linear(dst: str, src: str) -> None:
        flat[f"{dst}/kernel"] = np.ascontiguousarray(sd[f"{src}.weight"].T)
        flat[f"{dst}/bias"] = sd[f"{src}.bias"]

    def norm(dst: str, src: str) -> None:
        flat[f"{dst}/scale"] = sd[f"{src}.weight"]
        flat[f"{dst}/bias"] = sd[f"{src}.bias"]

    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        flat[f"embeddings/{name}"] = sd[f"embeddings.{name}.weight"]
    norm("embeddings/layer_norm", "embeddings.layer_norm")
    for i in range(config.num_hidden_layers):
        dst, src = f"layers/{i}", f"layers.{i}"
        for j, n in enumerate(("query", "key", "value")):
            if config.fused_qkv:
                rows = slice(j * h, (j + 1) * h)
                flat[f"{dst}/attention/{n}/kernel"] = np.ascontiguousarray(
                    sd[f"{src}.attention.qkv.weight"][rows].T)
                flat[f"{dst}/attention/{n}/bias"] = sd[f"{src}.attention.qkv.bias"][rows]
            else:
                linear(f"{dst}/attention/{n}", f"{src}.attention.{n}")
        linear(f"{dst}/attention/output", f"{src}.attention.output")
        norm(f"{dst}/attention/output_layer_norm", f"{src}.attention.output_layer_norm")
        linear(f"{dst}/mlp/intermediate", f"{src}.mlp.intermediate")
        linear(f"{dst}/mlp/output", f"{src}.mlp.output")
        norm(f"{dst}/mlp/output_layer_norm", f"{src}.mlp.output_layer_norm")
    linear("pooler", "pooler")
    return flat


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
