"""BERT-family encoder as a PyTorch module (port of :mod:`kirag_tpu.models.bert`).

One stack backs every bi-encoder (E5, BGE, Contriever); the pooling heads
live in :mod:`kirag_tpu_torch.models.encoders`. The arithmetic follows the
reference's plain path (``attention_impl="xla"``): embeddings and LayerNorm
statistics in f32, matmuls in the compute dtype, attention logits and
softmax in f32 with the additive ``finfo(f32).min`` mask, exact (erf) GELU
in f32. Parameters are kept in f32; linear layers cast their weights to the
activation dtype when called (a no-op once :class:`Encoder` has cast them).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


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

    def forward(self, x: torch.Tensor, mask_bias: torch.Tensor) -> torch.Tensor:
        b, t, h = x.shape
        nh, hd = self.config.num_attention_heads, self.config.head_dim
        if self.config.fused_qkv:
            q, k, v = _dense(x, self.qkv).split(h, dim=-1)
        else:
            q, k, v = (_dense(x, self.query), _dense(x, self.key), _dense(x, self.value))
        q = q.reshape(b, t, nh, hd)
        k = k.reshape(b, t, nh, hd)
        v = v.reshape(b, t, nh, hd)
        # [b, nh, t, t] logits and softmax in f32
        logits = torch.einsum("bqnd,bknd->bnqk", q.to(torch.float32), k.to(torch.float32))
        logits = logits / math.sqrt(hd) + mask_bias
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        ctx = torch.einsum("bnqk,bknd->bqnd", probs, v).reshape(b, t, h)
        return _dense(ctx, self.output)


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

    def forward(self, x: torch.Tensor, mask_bias: torch.Tensor) -> torch.Tensor:
        x = self.attention.output_layer_norm(x + self.attention(x, mask_bias))
        inter = F.gelu(_dense(x, self.mlp.intermediate).to(torch.float32))
        mlp_out = _dense(inter.to(x.dtype), self.mlp.output)
        return self.mlp.output_layer_norm(x + mlp_out)


class BertModel(nn.Module):
    """The transformer stack; ``forward`` returns last_hidden_state [B, T, H].

    ``generator`` seeds the random init (normal(0, 0.02) weights, zero
    biases, unit LayerNorm), the structure of ``init_bert_params``.
    """

    def __init__(self, config: BertConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.embeddings = Embeddings(config, device=device)
        self.layers = nn.ModuleList(Layer(config, device=device)
                                    for _ in range(config.num_hidden_layers))
        self.pooler = nn.Linear(config.hidden_size, config.hidden_size, device=device)
        self.init_weights(generator)

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
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        t = input_ids.shape[1]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = self.embeddings
        positions = torch.arange(t, device=input_ids.device)
        x = (emb.word_embeddings(input_ids) + emb.position_embeddings(positions)[None]
             + emb.token_type_embeddings(token_type_ids))
        x = emb.layer_norm(x).to(compute_dtype)
        neg = torch.finfo(torch.float32).min
        mask_bias = (1.0 - attention_mask[:, None, None, :].to(torch.float32)) * neg
        for layer in self.layers:
            x = layer(x, mask_bias)
        return x


def bert_encode(model: BertModel, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Run the stack; returns last_hidden_state [B, T, H] in ``compute_dtype``."""
    return model(input_ids, attention_mask, token_type_ids, compute_dtype)


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
