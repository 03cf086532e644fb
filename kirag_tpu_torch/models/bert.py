"""BERT-family encoder as a PyTorch module (port of :mod:`kirag_tpu.models.bert`).

One stack backs every bi-encoder (E5, BGE, Contriever); the pooling heads
live in :mod:`kirag_tpu_torch.models.encoders`. Embeddings and LayerNorm
statistics run in f32, matmuls in the compute dtype, exact (erf) GELU in
f32. Attention has the reference's two paths:

- ``"xla"``: einsum logits and softmax in f32 with the additive
  ``finfo(f32).min`` mask (or the block-diagonal bias of ``segment_ids``);
- ``"flash"``: the flash attention kernel (K3,
  :func:`kirag_tpu_torch.kernels.flash_attention`) with segment ids, so pad
  queries attend among pads instead of over the real keys; pad rows never
  reach the pooling heads.

``"auto"`` takes ``"flash"`` on a CUDA device for T % 128 == 0 and head_dim
64 (the reference's TPU gate read as "on the card"), else ``"xla"``.
Parameters are kept in f32; linear layers cast their weights to the
activation dtype when called (a no-op once :class:`Encoder` has cast them).

Tensor parallelism (:func:`shard_bert_model`, the reference's Megatron layout
of :func:`param_shardings`): over a mesh's model axis of M ranks, query,
key, value and the MLP's intermediate projection are column-parallel (each
rank nh/M heads and I/M columns), the attention output and the MLP output
row-parallel (each rank a partial product over its input range, summed over
the axis, then the replicated bias added once); embeddings, LayerNorms and
the pooler replicate. A fused QKV shard is ``[q_r; k_r; v_r]``, each h/M
rows. Every rank returns the same full hidden states; a forward (and a
backward) over a sharded model is a collective of the model axis.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from kirag_tpu_torch.kernels.attention import flash_attention
from kirag_tpu_torch.parallel.mesh import (
    TensorParallel,
    all_gather_list,
    copy_to_model,
    reduce_from_model,
)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    # one [3h, h] projection for q, k, v instead of three [h, h]
    fused_qkv: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def _dense(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    return F.linear(x, lin.weight.to(x.dtype), lin.bias.to(x.dtype))


def _to_model(x: torch.Tensor, tp: Optional[TensorParallel]) -> torch.Tensor:
    """The input of a column-parallel projection (its gradient summed over
    the model axis)."""
    return x if tp is None else copy_to_model(x, tp.mesh, tp.axis)


def _row_dense(x: torch.Tensor, lin: nn.Linear, tp: Optional[TensorParallel]) -> torch.Tensor:
    """A row-parallel projection: the ranks' partial products summed, then
    the replicated bias added once."""
    if tp is None:
        return _dense(x, lin)
    partial = F.linear(x, lin.weight.to(x.dtype))
    return reduce_from_model(partial, tp.mesh, tp.axis) + lin.bias.to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm with f32 statistics and affine, cast back to the input dtype."""

    def __init__(self, dim: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.layer_norm(x.to(torch.float32), self.weight.shape, self.weight, self.bias,
                           self.eps)
        return out.to(x.dtype)


class Embeddings(nn.Module):
    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        h = config.hidden_size
        self.word_embeddings = nn.Embedding(config.vocab_size, h, device=device)
        self.position_embeddings = nn.Embedding(config.max_position_embeddings, h, device=device)
        self.token_type_embeddings = nn.Embedding(config.type_vocab_size, h, device=device)
        self.layer_norm = LayerNorm(h, config.layer_norm_eps, device=device)


class Attention(nn.Module):
    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        h = config.hidden_size
        self.config = config
        if config.fused_qkv:
            self.qkv = nn.Linear(h, 3 * h, device=device)
        else:
            self.query = nn.Linear(h, h, device=device)
            self.key = nn.Linear(h, h, device=device)
            self.value = nn.Linear(h, h, device=device)
        self.output = nn.Linear(h, h, device=device)
        self.output_layer_norm = LayerNorm(h, config.layer_norm_eps, device=device)

    def forward(self, x: torch.Tensor, mask_bias: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None, impl: str = "xla",
                tp: Optional[TensorParallel] = None) -> torch.Tensor:
        """``impl="xla"`` takes the additive ``mask_bias``, ``"flash"`` the
        [B, T] ``segment_ids``; over ``tp`` this rank's heads only."""
        b, t, _ = x.shape
        nh = self.config.num_attention_heads // (1 if tp is None else tp.size)
        hd = self.config.head_dim
        h = nh * hd
        x_in = _to_model(x, tp)
        if self.config.fused_qkv:
            q, k, v = _dense(x_in, self.qkv).split(h, dim=-1)
        else:
            q, k, v = (_dense(x_in, self.query), _dense(x_in, self.key),
                       _dense(x_in, self.value))
        q = q.view(b, t, nh, hd)
        k = k.view(b, t, nh, hd)
        v = v.view(b, t, nh, hd)
        if impl == "flash":
            # [b, nh, t, hd] views of the projection: the kernel reads them by strides
            ctx = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                  segment_ids, 1.0 / math.sqrt(hd))
            return _row_dense(ctx.transpose(1, 2).reshape(b, t, h), self.output, tp)
        # [b, nh, t, t] logits and softmax in f32
        logits = torch.einsum("bqnd,bknd->bnqk", q.to(torch.float32), k.to(torch.float32))
        logits = logits / math.sqrt(hd) + mask_bias
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        ctx = torch.einsum("bnqk,bknd->bqnd", probs, v).reshape(b, t, h)
        return _row_dense(ctx, self.output, tp)


class Mlp(nn.Module):
    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        self.intermediate = nn.Linear(h, i, device=device)
        self.output = nn.Linear(i, h, device=device)
        self.output_layer_norm = LayerNorm(h, config.layer_norm_eps, device=device)


class Layer(nn.Module):
    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        self.attention = Attention(config, device=device)
        self.mlp = Mlp(config, device=device)

    def forward(self, x: torch.Tensor, mask_bias: Optional[torch.Tensor],
                segment_ids: Optional[torch.Tensor], impl: str,
                tp: Optional[TensorParallel] = None) -> torch.Tensor:
        x = self.attention.output_layer_norm(x + self.attention(x, mask_bias, segment_ids,
                                                                impl, tp))
        inter = F.gelu(_dense(_to_model(x, tp), self.mlp.intermediate).to(torch.float32))
        mlp_out = _row_dense(inter.to(x.dtype), self.mlp.output, tp)
        return self.mlp.output_layer_norm(x + mlp_out)


class BertModel(nn.Module):
    """The transformer stack; ``forward`` returns last_hidden_state [B, T, H].

    ``generator`` seeds the random init (normal(0, 0.02) weights, zero
    biases, unit LayerNorm), the structure of ``init_bert_params``. ``tp``
    is the model axis a rank-local model of :func:`shard_bert_model` is
    sharded over (None: the whole model).
    """

    def __init__(self, config: BertConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.tp: Optional[TensorParallel] = None
        self.embeddings = Embeddings(config, device=device)
        self.layers = nn.ModuleList(Layer(config, device=device)
                                    for _ in range(config.num_hidden_layers))
        self.pooler = nn.Linear(config.hidden_size, config.hidden_size, device=device)
        self.init_weights(generator)

    def shard_dims(self) -> Dict[str, Optional[int]]:
        """Each parameter's dim sharded over ``tp`` (None: replicated; every
        one None for a whole model)."""
        if self.tp is None or self.tp.size == 1:
            return {name: None for name, _ in self.named_parameters()}
        return state_dict_shardings(self.config)

    def cut_shard(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the whole model's tensor ``name`` (a view)."""
        dim = self.shard_dims()[name]
        return whole if dim is None else cut_shard(name, whole, dim, self.tp.size,
                                                   self.tp.index)

    def join_shards(self, name: str, shards) -> torch.Tensor:
        """The whole tensor ``name`` from every rank's shard, in rank order."""
        return join_shards(name, shards, self.shard_dims()[name])

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                nn.init.normal_(m.weight, std=0.02, generator=generator)
            if isinstance(m, nn.Linear):
                nn.init.zeros_(m.bias)
            if isinstance(m, LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                compute_dtype: torch.dtype = torch.float32, attention_impl: str = "auto",
                position_ids: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """last_hidden_state [B, T, H] in ``compute_dtype``.

        ``position_ids`` / ``segment_ids`` pack several documents into one row:
        positions restart per document, and attention stays within a segment
        (segment 0 is padding, whose tokens attend among themselves)."""
        t = input_ids.shape[1]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if position_ids is None:
            position_ids = torch.arange(t, device=input_ids.device)[None]
        emb = self.embeddings
        x = (emb.word_embeddings(input_ids) + emb.position_embeddings(position_ids)
             + emb.token_type_embeddings(token_type_ids))
        x = emb.layer_norm(x).to(compute_dtype)
        impl = _resolve_attention_impl(attention_impl, x.device, t, self.config)
        seg = attention_mask if segment_ids is None else segment_ids
        mask_bias = None
        if impl == "xla":
            neg = torch.finfo(torch.float32).min
            if segment_ids is None:
                mask_bias = (1.0 - attention_mask[:, None, None, :].to(torch.float32)) * neg
            else:
                same = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
                mask_bias = torch.where(same, 0.0, neg)
        # a model axis of one rank runs the unsharded forward
        tp = self.tp if self.tp is not None and self.tp.size > 1 else None
        for layer in self.layers:
            x = layer(x, mask_bias, seg, impl, tp)
        return x


def _resolve_attention_impl(impl: str, device: torch.device, t: int, config: BertConfig) -> str:
    if impl not in ("auto", "flash", "xla"):
        raise KeyError(f"attention_impl must be auto|flash|xla, got {impl!r}")
    if impl != "auto":
        return impl
    if device.type == "cuda" and t % 128 == 0 and config.head_dim == 64:
        return "flash"
    return "xla"


def bert_encode(model: BertModel, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                compute_dtype: torch.dtype = torch.float32, attention_impl: str = "auto",
                position_ids: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run the stack; returns last_hidden_state [B, T, H] in ``compute_dtype``.
    ``attention_impl``: "xla", "flash" or "auto" (see the module docstring)."""
    return model(input_ids, attention_mask, token_type_ids, compute_dtype, attention_impl,
                 position_ids, segment_ids)


def param_shardings(config: BertConfig) -> Dict[str, Any]:
    """The reference's tensor-parallel layout (port of
    ``kirag_tpu.models.bert.param_shardings``), as the dim of each leaf of
    its parameter pytree that shards over the model axis (None: replicated),
    as :func:`~kirag_tpu_torch.models.llm.llama_param_shardings` gives it:
    column-parallel kernels [in, out] (query, key, value, intermediate) on
    dim 1 and their biases on 0; row-parallel kernels (the attention and MLP
    outputs) on dim 0, their biases replicated; LayerNorms, embeddings and
    the pooler replicated."""
    col = {"kernel": 1, "bias": 0}
    row = {"kernel": 0, "bias": None}
    ln = {"scale": None, "bias": None}
    layer = {"attention": {"query": col, "key": col, "value": col, "output": row,
                           "output_layer_norm": ln},
             "mlp": {"intermediate": col, "output": row, "output_layer_norm": ln}}
    return {"embeddings": {"word_embeddings": None, "position_embeddings": None,
                           "token_type_embeddings": None, "layer_norm": ln},
            "layers": [layer] * config.num_hidden_layers,
            "pooler": {"kernel": None, "bias": None}}


def state_dict_shardings(config: BertConfig) -> Dict[str, Optional[int]]:
    """:func:`param_shardings` by the names of :class:`BertModel`'s state
    dict: ``nn.Linear`` weights are [out, in], so a column-parallel weight
    shards on dim 0 and a row-parallel one on dim 1. A fused ``qkv`` takes
    the query's spec (q, k and v shard alike)."""
    specs = param_shardings(config)
    dims: Dict[str, Optional[int]] = {}

    def linear(name: str, spec) -> None:
        dims[f"{name}.weight"] = None if spec["kernel"] is None else 1 - spec["kernel"]
        dims[f"{name}.bias"] = spec["bias"]

    def norm(name: str, spec) -> None:
        dims[f"{name}.weight"], dims[f"{name}.bias"] = spec["scale"], spec["bias"]

    emb = specs["embeddings"]
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        dims[f"embeddings.{name}.weight"] = emb[name]
    norm("embeddings.layer_norm", emb["layer_norm"])
    for i, layer in enumerate(specs["layers"]):
        att, pre = layer["attention"], f"layers.{i}.attention"
        if config.fused_qkv:
            linear(f"{pre}.qkv", att["query"])
        else:
            for n in ("query", "key", "value"):
                linear(f"{pre}.{n}", att[n])
        linear(f"{pre}.output", att["output"])
        norm(f"{pre}.output_layer_norm", att["output_layer_norm"])
        mlp, pre = layer["mlp"], f"layers.{i}.mlp"
        linear(f"{pre}.intermediate", mlp["intermediate"])
        linear(f"{pre}.output", mlp["output"])
        norm(f"{pre}.output_layer_norm", mlp["output_layer_norm"])
    linear("pooler", specs["pooler"])
    return dims


def _fused(name: str) -> bool:
    return name.rsplit(".", 2)[-2] == "qkv"


def cut_shard(name: str, tensor: torch.Tensor, dim: Optional[int], size: int,
              index: int) -> torch.Tensor:
    """Shard ``index`` of ``size`` of a state-dict tensor along ``dim`` (a
    view; None: the tensor). A fused ``qkv`` leaf takes the rows
    ``[q_r; k_r; v_r]``, its rank's rows of each third."""
    if dim is None:
        return tensor
    if _fused(name):
        thirds = tensor.unflatten(0, (3, -1))
        n = thirds.shape[1] // size
        return thirds.narrow(1, index * n, n).flatten(0, 1)
    n = tensor.shape[dim] // size
    return tensor.narrow(dim, index * n, n)


def join_shards(name: str, shards, dim: Optional[int]) -> torch.Tensor:
    """The inverse of :func:`cut_shard` over every rank's shard, in rank
    order."""
    if dim is None:
        return shards[0]
    if _fused(name):
        return torch.cat([s.unflatten(0, (3, -1)) for s in shards], dim=1).flatten(0, 1)
    return torch.cat(list(shards), dim=dim)


def check_tensor_parallel(config: BertConfig, size: int) -> None:
    """Raise ValueError unless a model axis of ``size`` ranks divides the
    heads and the intermediate size."""
    problems = [f"{what} {n} % {size} != 0" for what, n in (
        ("attention heads", config.num_attention_heads),
        ("intermediate size", config.intermediate_size)) if n % size]
    if problems:
        raise ValueError(f"a model axis of {size} ranks cannot shard this encoder: "
                         + "; ".join(problems))


def shard_bert_model(model: BertModel, mesh, model_axis: str = "model") -> BertModel:
    """A new rank-local :class:`BertModel` holding this rank's shard of each
    of ``model``'s parameters over ``mesh[model_axis]`` (copies, on the same
    device, in the same dtypes; ``model`` itself is untouched), carrying its
    :class:`~kirag_tpu_torch.parallel.mesh.TensorParallel`. Raises ValueError
    for a model axis that does not divide the heads or the intermediate
    size."""
    tp = TensorParallel(mesh, model_axis)
    check_tensor_parallel(model.config, tp.size)
    dims = state_dict_shardings(model.config)
    local = BertModel(model.config, device="meta")
    for name, p in model.named_parameters():
        shard = cut_shard(name, p.detach(), dims[name], tp.size, tp.index).clone()
        owner, leaf = name.rsplit(".", 1)
        setattr(local.get_submodule(owner), leaf,
                nn.Parameter(shard, requires_grad=p.requires_grad))
    local.tp = tp
    return local.train(model.training)


def gather_state_dict(model: BertModel) -> Dict[str, torch.Tensor]:
    """The whole model's state dict (detached) from every rank's shard of a
    :func:`shard_bert_model` model: a collective of its model axis. An
    unsharded model's own tensors."""
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    tp = model.tp
    if tp is None or tp.size == 1:
        return sd
    return {k: model.join_shards(k, all_gather_list(v, tp.mesh, tp.axis))
            for k, v in sd.items()}


def params_from_jax(params: Dict[str, Any], config: BertConfig) -> Dict[str, torch.Tensor]:
    """State dict of :class:`BertModel` from the JAX parameter pytree
    (``init_bert_params`` structure, leaves as numpy arrays). JAX kernels are
    [in, out] and ``nn.Linear`` weights [out, in]; with ``config.fused_qkv``
    the q, k and v projections are stacked into one ``qkv`` weight."""

    def t(x) -> torch.Tensor:
        return torch.from_numpy(np.array(x, dtype=np.float32))

    sd: Dict[str, torch.Tensor] = {}

    def linear(name: str, p) -> None:
        sd[f"{name}.weight"] = t(np.asarray(p["kernel"]).T)
        sd[f"{name}.bias"] = t(p["bias"])

    def norm(name: str, p) -> None:
        sd[f"{name}.weight"] = t(p["scale"])
        sd[f"{name}.bias"] = t(p["bias"])

    emb = params["embeddings"]
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        sd[f"embeddings.{name}.weight"] = t(emb[name])
    norm("embeddings.layer_norm", emb["layer_norm"])
    for i, lp in enumerate(params["layers"]):
        att, pre = lp["attention"], f"layers.{i}.attention"
        if config.fused_qkv:
            sd[f"{pre}.qkv.weight"] = t(np.concatenate(
                [np.asarray(att[n]["kernel"]).T for n in ("query", "key", "value")], axis=0))
            sd[f"{pre}.qkv.bias"] = t(np.concatenate(
                [np.asarray(att[n]["bias"]) for n in ("query", "key", "value")]))
        else:
            for n in ("query", "key", "value"):
                linear(f"{pre}.{n}", att[n])
        linear(f"{pre}.output", att["output"])
        norm(f"{pre}.output_layer_norm", att["output_layer_norm"])
        mlp, pre = lp["mlp"], f"layers.{i}.mlp"
        linear(f"{pre}.intermediate", mlp["intermediate"])
        linear(f"{pre}.output", mlp["output"])
        norm(f"{pre}.output_layer_norm", mlp["output_layer_norm"])
    linear("pooler", params["pooler"])
    return sd


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to(device="cpu", dtype=torch.float32)
    return torch.from_numpy(np.array(x, dtype=np.float32))


def convert_hf_state_dict(state_dict: Mapping[str, Any],
                          config: BertConfig) -> Dict[str, torch.Tensor]:
    """State dict of :class:`BertModel` from an HF ``BertModel`` state dict
    (numpy arrays or tensors, keys with or without a leading ``bert.``). HF
    linear weights are already [out, in]; with ``config.fused_qkv`` q, k and
    v are stacked into one ``qkv`` weight. A checkpoint without a pooler gets
    a zero one (no pooling head reads it)."""
    hf = {key.removeprefix("bert."): value for key, value in state_dict.items()}
    sd: Dict[str, torch.Tensor] = {}

    def copy(dst: str, src: str) -> None:
        sd[f"{dst}.weight"] = _f32(hf[f"{src}.weight"])
        sd[f"{dst}.bias"] = _f32(hf[f"{src}.bias"])

    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        sd[f"embeddings.{name}.weight"] = _f32(hf[f"embeddings.{name}.weight"])
    copy("embeddings.layer_norm", "embeddings.LayerNorm")
    for i in range(config.num_hidden_layers):
        src, dst = f"encoder.layer.{i}", f"layers.{i}"
        qkv = [f"{src}.attention.self.{n}" for n in ("query", "key", "value")]
        if config.fused_qkv:
            for part in ("weight", "bias"):
                sd[f"{dst}.attention.qkv.{part}"] = torch.cat(
                    [_f32(hf[f"{n}.{part}"]) for n in qkv])
        else:
            for n, name in zip(("query", "key", "value"), qkv):
                copy(f"{dst}.attention.{n}", name)
        copy(f"{dst}.attention.output", f"{src}.attention.output.dense")
        copy(f"{dst}.attention.output_layer_norm", f"{src}.attention.output.LayerNorm")
        copy(f"{dst}.mlp.intermediate", f"{src}.intermediate.dense")
        copy(f"{dst}.mlp.output", f"{src}.output.dense")
        copy(f"{dst}.mlp.output_layer_norm", f"{src}.output.LayerNorm")
    if "pooler.dense.weight" in hf:
        copy("pooler", "pooler.dense")
    else:
        sd["pooler.weight"] = torch.zeros(config.hidden_size, config.hidden_size)
        sd["pooler.bias"] = torch.zeros(config.hidden_size)
    return sd


def config_from_hf(hf_config) -> BertConfig:
    """A :class:`BertConfig` from a transformers BertConfig object or its
    ``config.json`` dict."""
    get = (hf_config.get if isinstance(hf_config, dict)
           else lambda key, default=None: getattr(hf_config, key, default))
    return BertConfig(
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        num_hidden_layers=get("num_hidden_layers"),
        num_attention_heads=get("num_attention_heads"),
        intermediate_size=get("intermediate_size"),
        max_position_embeddings=get("max_position_embeddings"),
        type_vocab_size=get("type_vocab_size", 2),
        layer_norm_eps=get("layer_norm_eps", 1e-12),
        pad_token_id=get("pad_token_id", 0) or 0,
    )
