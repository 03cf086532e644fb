"""Llama-family decoder-only LM in PyTorch with KV-cache greedy decode (port
of :mod:`kirag_tpu.models.llm`).

The generation backend behind :class:`kirag_tpu_torch.generation.Generator`:
Llama-2/3/3.1, Qwen2 (QKV biases), Mistral and Gemma-2 (sandwich norms,
GeGLU, soft-capping, alternating sliding-window attention). Parameters are a
dict of tensors in the reference's layout: kernels ``[in, out]``, int8
``kernel_q`` [in, out] + ``kernel_scale`` [out], 4-bit ``kernel_q4``
[in/2, out] uint8 + ``kernel_scale4`` [in/64, out] f32 (+ ``kernel_cb4``
[16] for NF4).

Decode: prefill, then one step per generated token in a Python loop (the
reference's ``lax.scan``) over a preallocated KV cache, in the compute dtype
or, with ``config.kv_quant_bits == 8``, int8 codes with one f32 scale per
(token, KV head). The cache, its mask and positions are updated in place;
a state handed to :func:`resume_decode` is consumed by it. With 4-bit weights and
``config.int4_impl == "kernel"``, every projection of a step with at most 32
rows goes through the hand-written kernel :func:`~kirag_tpu_torch.kernels.qmm.int4_matmul`
(K6); prefill (more rows) takes the "parity" formulation in plain PyTorch, as
the reference does (``kirag_tpu/models/llm.py:294-314``).

Tensor parallelism (:meth:`TorchLlamaBackend.shard_params`, the reference's
Megatron layout of :func:`llama_param_shardings`): over a mesh's model axis
of M ranks, q/k/v and gate/up are column-parallel (each rank its H/M query
heads and H_kv/M KV heads, and I/M MLP columns), o and down row-parallel
(each rank a partial sum over its input range, then an all-reduce), and the
lm_head column-parallel (each rank V/M logits, then an all-gather of the
vocabulary). The KV cache holds the rank's heads only. A sharded params tree
carries its :class:`TensorParallel` under ``"tp"``, which every forward here
reads, so the decode functions take it as they take an unsharded tree. A
decode over a sharded tree is a collective: every rank of the model axis
calls it with the same inputs.

The prefix-KV pool (:func:`alloc_prefix_pool`, :func:`write_prefix_pool`,
:func:`greedy_decode_prefixed`) caches shared prompt prefixes' K/V in the
cache format; :class:`TorchLlamaBackend` reaches it through ``prefix_groups``
and speculative decoding (:mod:`kirag_tpu_torch.models.speculative`) through
a draft model.

Entry points (:func:`init_llama_params`, :func:`llama_params_from_jax`,
:func:`load_llama`, :func:`alloc_prefix_pool`) build on the GPU unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from kirag_tpu_torch.device import require_cuda
from kirag_tpu_torch.kernels.qmm import int4_matmul, supported
from kirag_tpu_torch.parallel.mesh import TensorParallel, all_gather_cols, all_reduce_sum

Params = Dict[str, Any]

# attention over a long prompt runs this many queries at a time, so the f32
# logits of a 4096-token prefill stay ~1 GB instead of the reference's
# [B, nh, T, T] in one piece; every logit and softmax row is the same
PREFILL_QUERY_CHUNK = 512
# output columns quantized at a time, to bound the temporaries of the
# quantizers on an 8B model (quantization is per column: chunking is exact)
QUANT_COLUMNS = 8192


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    intermediate_size: int = 14336
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    tie_word_embeddings: bool = False
    attention_bias: bool = False  # True for Qwen2 QKV
    # 4-bit matmul formulation: "parity", "blockdot" (plain PyTorch, as the
    # reference's XLA ones) or "kernel" (K6 for steps of <= 32 rows, the
    # reference's "pallas"); load_llama picks "kernel" on the GPU
    int4_impl: str = "parity"
    # 8: the decode KV cache stored as int8 codes with an f32 scale per
    # (token, KV head) (``_kv_quantize``); None: in the compute dtype
    kv_quant_bits: Optional[int] = None
    # Gemma-2 extensions (model_type == "gemma2")
    model_type: str = "llama"
    head_dim_override: Optional[int] = None
    query_pre_attn_scalar: Optional[float] = None
    attn_logit_softcapping: Optional[float] = None
    final_logit_softcapping: Optional[float] = None
    sliding_window: Optional[int] = None          # applied on every other layer
    hidden_activation: str = "silu"               # gemma2: gelu_pytorch_tanh

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.hidden_size // self.num_attention_heads

    @property
    def is_gemma2(self) -> bool:
        return self.model_type == "gemma2"


def config_from_hf(hf_config) -> LlamaConfig:
    get = hf_config.get if isinstance(hf_config, dict) else lambda k, d=None: getattr(hf_config, k, d)
    model_type = str(get("model_type", "llama"))
    is_gemma2 = model_type == "gemma2"
    return LlamaConfig(
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        num_hidden_layers=get("num_hidden_layers"),
        num_attention_heads=get("num_attention_heads"),
        num_key_value_heads=get("num_key_value_heads") or get("num_attention_heads"),
        intermediate_size=get("intermediate_size"),
        max_position_embeddings=get("max_position_embeddings", 8192),
        rms_norm_eps=get("rms_norm_eps", 1e-5 if not is_gemma2 else 1e-6),
        rope_theta=get("rope_theta", 10000.0),
        tie_word_embeddings=bool(get("tie_word_embeddings", is_gemma2)),
        attention_bias=bool(get("attention_bias", False)) or "qwen" in model_type,
        model_type="gemma2" if is_gemma2 else "llama",
        head_dim_override=get("head_dim") if is_gemma2 else None,
        query_pre_attn_scalar=get("query_pre_attn_scalar") if is_gemma2 else None,
        attn_logit_softcapping=get("attn_logit_softcapping") if is_gemma2 else None,
        final_logit_softcapping=get("final_logit_softcapping") if is_gemma2 else None,
        sliding_window=get("sliding_window") if is_gemma2 else None,
        hidden_activation=("gelu_pytorch_tanh" if is_gemma2
                           else str(get("hidden_act", "silu"))),
    )


def _check_config(config: LlamaConfig) -> None:
    if config.kv_quant_bits not in (None, 8):
        raise ValueError(f"kv_quant_bits must be None or 8, got {config.kv_quant_bits}")
    if config.int4_impl not in ("parity", "blockdot", "kernel"):
        raise KeyError(f"int4_impl must be parity|blockdot|kernel, got {config.int4_impl!r}")


def _entry_device(device) -> torch.device:
    return require_cuda() if device is None else torch.device(device)


# ----------------------------------------------------------------- tensor parallelism


def _local_heads(params: Params, config: LlamaConfig) -> Tuple[int, int]:
    """(query heads, KV heads) of this rank: all of them, or 1/M of each
    over a model axis of M ranks."""
    tp = params.get("tp")
    m = 1 if tp is None else tp.size
    return config.num_attention_heads // m, config.num_key_value_heads // m


def _tp_sum(x: torch.Tensor, tp: Optional[TensorParallel]) -> torch.Tensor:
    """A row-parallel projection's partial sums added over the model axis."""
    return x if tp is None else all_reduce_sum(x, tp.mesh, tp.axis)


def _tp_gather_vocab(logits: torch.Tensor, tp: Optional[TensorParallel]) -> torch.Tensor:
    """The column-parallel lm_head's [..., V/M] logits of every rank, in
    rank order along the vocabulary."""
    if tp is None:
        return logits
    lead = logits.shape[:-1]
    full = all_gather_cols(logits.reshape(-1, logits.shape[-1]), tp.mesh, tp.axis)
    return full.reshape(*lead, full.shape[-1])


_COLUMN = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj", "lm_head")
_ROW = ("o_proj", "down_proj")


def llama_param_shardings(config: LlamaConfig) -> Params:
    """The reference's Megatron layout for a float params tree (port of
    ``kirag_tpu.models.llm.llama_param_shardings``), as the dim of each leaf
    that shards over the model axis (None: replicated): column-parallel
    kernels [in, out] on dim 1 (their biases on 0), row-parallel kernels on
    dim 0; norms and the embedding replicated."""
    col = {"kernel": 1, "bias": 0} if config.attention_bias else {"kernel": 1}
    layer = {"input_layernorm": {"scale": None}, "post_attention_layernorm": {"scale": None},
             "q_proj": col, "k_proj": col, "v_proj": col, "o_proj": {"kernel": 0},
             "gate_proj": {"kernel": 1}, "up_proj": {"kernel": 1}, "down_proj": {"kernel": 0}}
    specs: Params = {"embed_tokens": None, "norm": {"scale": None},
                     "layers": [layer] * config.num_hidden_layers}
    if not config.tie_word_embeddings:
        specs["lm_head"] = {"kernel": 1}
    return specs


def llama_param_shardings_like(params: Params) -> Params:
    """:func:`llama_param_shardings` matching the structure of ``params``,
    quantized trees included (port of ``llama_param_shardings_like``): int8
    ``kernel_q`` follows the kernel, its per-output ``kernel_scale`` shards
    with the output columns (replicated on a row-parallel projection); int4
    ``kernel_q4`` [in/2, out] follows the kernel and ``kernel_scale4``
    [in/64, out] shards with it on either dim, whole 64-row blocks on a
    row-parallel one (the reference replicates the scale rows there: here
    each rank's K6 takes the scales of its own input rows); the NF4
    codebook, norms (gemma2's sandwich norms too) and the embedding
    replicate. A row-parallel bias, which no supported family has, shards
    nowhere."""
    def proj(p, row: bool):
        out = {}
        for name in p:
            if name in ("kernel", "kernel_q", "kernel_q4", "kernel_scale4"):
                out[name] = 0 if row else 1
            elif name in ("kernel_scale", "bias"):
                out[name] = None if row else 0
            else:  # kernel_cb4
                out[name] = None
        return out

    specs: Params = {"embed_tokens": None, "norm": {"scale": None}, "layers": [
        {name: (proj(p, name in _ROW) if name in _COLUMN + _ROW
                else {k: None for k in p}) for name, p in layer.items()}
        for layer in params["layers"]]}
    if "lm_head" in params:
        specs["lm_head"] = proj(params["lm_head"], False)
    return specs


def _check_tp(params: Params, config: LlamaConfig, m: int) -> None:
    """Raise unless a model axis of ``m`` ranks can take ``params``: the
    heads, the MLP width and the vocabulary divide by m, an int4
    row-parallel shard is whole 64-row blocks, no row-parallel projection
    has a bias, and on the card every int4 shard is a shape K6 takes."""
    problems = []
    for what, n in (("attention heads", config.num_attention_heads),
                    ("KV heads", config.num_key_value_heads),
                    ("intermediate size", config.intermediate_size),
                    ("vocabulary", config.vocab_size)):
        if n % m:
            problems.append(f"{what} {n} % {m} != 0")
    kernel = params["embed_tokens"].is_cuda and config.int4_impl == "kernel"
    projections = [(name, p) for layer in params["layers"] for name, p in layer.items()
                   if name in _COLUMN + _ROW]
    if "lm_head" in params:
        projections.append(("lm_head", params["lm_head"]))
    for name, p in projections:
        row = name in _ROW
        if row and "bias" in p:
            problems.append(f"{name} has a bias (row-parallel)")
        if "kernel_q4" not in p:
            continue
        half, out_dim = p["kernel_q4"].shape
        if row and half % (m * INT4_BLOCK // 2):
            problems.append(f"{name}: {2 * half} input rows do not cut into {m} ranges of "
                            f"whole {INT4_BLOCK}-row blocks")
        shard = (half // m, out_dim) if row else (half, out_dim // m)
        if kernel and not supported(*shard):
            problems.append(f"{name}: K6 takes no [{shard[0]}, {shard[1]}] shard (the kernel "
                            "runs every decode projection on the card)")
    if problems:
        raise ValueError(f"a model axis of {m} ranks cannot shard these params: "
                         + "; ".join(sorted(set(problems))))


def shard_llama_params(params: Params, config: LlamaConfig, mesh,
                       model_axis: str = "model") -> Params:
    """This rank's part of ``params`` over ``mesh[model_axis]`` (each leaf
    cut along the dim :func:`llama_param_shardings_like` names, copied so
    that the whole tree can be freed), carrying its :class:`TensorParallel`
    under ``"tp"``. Raises ValueError for a tree the axis cannot take
    (:func:`_check_tp`)."""
    tp = TensorParallel(mesh, model_axis)
    _check_tp(params, config, tp.size)

    def cut(leaf, dim):
        if dim is None:
            return leaf
        n = leaf.shape[dim] // tp.size
        return leaf.narrow(dim, tp.index * n, n).clone()

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(x, sp) for x, sp in zip(node, spec)]
        return cut(node, spec)

    out = walk(params, llama_param_shardings_like(params))
    out["tp"] = tp
    return out


# ----------------------------------------------------------------- quantizers

INT4_BLOCK = 64  # input rows per int4 quantization block (NF4 uses 64 too)

# The bitsandbytes NF4 codebook (the reference's 4-bit weight format): the 16
# quantiles of a standard normal, normalized to [-1, 1].
NF4_CODEBOOK = np.array(
    [-1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
     -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
     0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
     0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
     0.7229568362236023, 1.0], dtype=np.float32)


def _by_columns(quantize):
    """Run a per-column quantizer over QUANT_COLUMNS output columns at a
    time and join the pieces (the same bytes as one pass)."""
    def run(kernel: torch.Tensor, *args) -> Dict[str, torch.Tensor]:
        kernel = torch.as_tensor(kernel)
        if kernel.shape[1] <= QUANT_COLUMNS:
            return quantize(kernel, *args)
        parts = [quantize(kernel[:, c:c + QUANT_COLUMNS], *args)
                 for c in range(0, kernel.shape[1], QUANT_COLUMNS)]
        out = {k: torch.cat([p[k] for p in parts], dim=-1) for k in parts[0]
               if k != "kernel_cb4"}
        if "kernel_cb4" in parts[0]:
            out["kernel_cb4"] = parts[0]["kernel_cb4"]
        return out
    run.__doc__ = quantize.__doc__
    return run


def _pad_rows(k: torch.Tensor, block: int) -> torch.Tensor:
    in_dim = k.shape[0]
    in_pad = -(-in_dim // block) * block
    return F.pad(k, (0, 0, 0, in_pad - in_dim)) if in_pad != in_dim else k


@_by_columns
def _quantize_kernel_int8(kernel: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-output-channel symmetric int8 of a [in, out] kernel, on the
    kernel's device; the bytes of the reference's quantizer."""
    k = kernel.to(torch.float32)
    absmax = k.abs().amax(dim=0)
    scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax / 127.0)
    q = torch.clamp(torch.round(k / scale[None, :]), -127, 127).to(torch.int8)
    return {"kernel_q": q, "kernel_scale": scale}


@_by_columns
def _quantize_kernel_int4(kernel: torch.Tensor, block: int = INT4_BLOCK
                          ) -> Dict[str, torch.Tensor]:
    """Blockwise symmetric int4 of a [in, out] kernel: one f32 scale per
    (64-input-row block, output column), two signed nibbles per byte along
    the input dim (low nibble = even row); the reference's bytes."""
    k = _pad_rows(kernel.to(torch.float32), block)
    in_pad, out_dim = k.shape
    blocks = k.reshape(in_pad // block, block, out_dim)
    absmax = blocks.abs().amax(dim=1)                               # [nb, out]
    scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax / 7.0)
    q = torch.clamp(torch.round(blocks / scale[:, None, :]), -7, 7).to(torch.int16)
    q = q.reshape(in_pad, out_dim)
    packed = ((q[0::2] & 0x0F) | ((q[1::2] << 4) & 0xF0)).to(torch.uint8)
    return {"kernel_q4": packed, "kernel_scale4": scale}


@_by_columns
def _quantize_kernel_nf4(kernel: torch.Tensor, block: int = INT4_BLOCK,
                         codebook=NF4_CODEBOOK) -> Dict[str, torch.Tensor]:
    """Blockwise NF4 of a [in, out] kernel (the reference's bitsandbytes
    format): per (64-input-row block, output column) absmax scale, each value
    snapped to the nearest of the 16 codebook entries (the codebook first
    rounded to bf16), two unsigned indices per byte (low nibble = even row);
    the reference's bytes."""
    k = _pad_rows(kernel.to(torch.float32), block)
    cb = (torch.as_tensor(np.asarray(codebook, dtype=np.float32), device=k.device)
          .to(torch.bfloat16).to(torch.float32))
    if cb.shape != (16,) or not bool((cb[1:] > cb[:-1]).all()):
        raise ValueError("the codebook must hold 16 increasing values")
    in_pad, out_dim = k.shape
    blocks = k.reshape(in_pad // block, block, out_dim)
    absmax = blocks.abs().amax(dim=1)                               # [nb, out]
    scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax)
    normed = blocks / scale[:, None, :]
    mids = (cb[1:] + cb[:-1]) / 2.0
    idx = torch.searchsorted(mids, normed.reshape(-1), right=False).to(torch.uint8)
    idx = idx.reshape(in_pad, out_dim)
    packed = idx[0::2] | (idx[1::2] << 4)
    return {"kernel_q4": packed, "kernel_scale4": scale, "kernel_cb4": cb}


_PROJ_NAMES = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


def _quantizer(bits: Optional[int], int4_codebook: str):
    if bits is None:
        return None
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if int4_codebook not in ("nf4", "linear"):
        raise ValueError(f"int4_codebook must be nf4|linear, got {int4_codebook}")
    if bits == 8:
        return _quantize_kernel_int8
    return _quantize_kernel_nf4 if int4_codebook == "nf4" else _quantize_kernel_int4


def quantize_llama_params(params: Params, bits: int = 8,
                          int4_codebook: str = "nf4") -> Params:
    """Weight-only quantization of every projection kernel (q/k/v/o/gate/up/
    down and lm_head), on each kernel's device: int8 with per-column scales,
    or 4-bit with block-64 scales (NF4 by default, ``"linear"`` for the
    signed integer grid). Embeddings and norms stay as they are."""
    quantize = _quantizer(bits, int4_codebook)

    def quant_lin(p):
        if "kernel" not in p:
            return p
        out = quantize(p["kernel"])
        if "bias" in p:
            out["bias"] = p["bias"]
        return out

    out: Params = {"embed_tokens": params["embed_tokens"], "norm": params["norm"],
                   "layers": []}
    if "lm_head" in params:
        out["lm_head"] = quant_lin(params["lm_head"])
    for layer in params["layers"]:
        out["layers"].append({name: (quant_lin(p) if name in _PROJ_NAMES else p)
                              for name, p in layer.items()})
    return out


# ----------------------------------------------------------------- parameters


def init_llama_params(config: LlamaConfig, seed: int = 0, device=None,
                      dtype: torch.dtype = torch.float32, quant_bits: Optional[int] = None,
                      int4_codebook: str = "nf4") -> Params:
    """Seeded random parameters in the reference's layout (normal, std 0.02;
    unit norm scales, zero biases), built on ``device`` (default: the GPU).
    Float matrices are stored in ``dtype``, 1-D leaves in f32, as
    :func:`load_llama` casts. With ``quant_bits`` each projection kernel is
    quantized right after it is drawn, on the device, so an 8B model never
    sits whole in f32. The numbers differ from ``jax.random``'s; tests carry
    the reference's parameters across with :func:`llama_params_from_jax`."""
    _check_config(config)
    device = _entry_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    quantize = _quantizer(quant_bits, int4_codebook)
    h, i = config.hidden_size, config.intermediate_size
    kv_dim = config.num_key_value_heads * config.head_dim

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=device) * 0.02

    def lin(in_dim, out_dim, bias=False):
        kernel = normal(in_dim, out_dim)
        p = quantize(kernel) if quantize is not None else {"kernel": kernel.to(dtype)}
        del kernel
        if bias:
            p["bias"] = torch.zeros(out_dim, device=device)
        return p

    ones = lambda: torch.ones(h, device=device)  # noqa: E731
    params: Params = {"embed_tokens": normal(config.vocab_size, h).to(dtype),
                      "norm": {"scale": ones()}, "layers": []}
    if not config.tie_word_embeddings:
        params["lm_head"] = lin(h, config.vocab_size)
    b = config.attention_bias
    for _ in range(config.num_hidden_layers):
        params["layers"].append({
            "input_layernorm": {"scale": ones()},
            "post_attention_layernorm": {"scale": ones()},
            "q_proj": lin(h, config.num_attention_heads * config.head_dim, bias=b),
            "k_proj": lin(h, kv_dim, bias=b),
            "v_proj": lin(h, kv_dim, bias=b),
            "o_proj": lin(config.num_attention_heads * config.head_dim, h),
            "gate_proj": lin(h, i),
            "up_proj": lin(h, i),
            "down_proj": lin(i, h),
        })
    return params


def _tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: the upper half of an f32
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def llama_params_from_jax(tree, device=None) -> Params:
    """The JAX package's parameter pytree (leaves as numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as tensors on ``device`` (default:
    the GPU), in the same structure and dtypes: float, int8 and 4-bit trees,
    biases and the Gemma-2 norms."""
    device = _entry_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return _tensor_from_numpy(node, device)

    return walk(tree)


def param_bytes(params: Params) -> int:
    """Bytes of every tensor in the tree (this rank's of a sharded one)."""
    if isinstance(params, dict):
        return sum(param_bytes(v) for v in params.values())
    if isinstance(params, list):
        return sum(param_bytes(v) for v in params)
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    return 0  # a sharded tree's TensorParallel


# ----------------------------------------------------------------- layers


def _rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
              plus_one: bool = False) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    w = scale.to(torch.float32)
    if plus_one:  # gemma2 parameterizes the scale as (1 + w)
        w = 1.0 + w
    return (out * w).to(x.dtype)


def _unpack_int4(packed: torch.Tensor, dtype) -> torch.Tensor:
    """[in/2, out] uint8 (two signed nibbles per byte, low = even row) ->
    [in, out] values in ``dtype``."""
    p = packed.view(torch.int8)
    lo = torch.bitwise_left_shift(p, 4) >> 4
    hi = p >> 4
    half, out = p.shape
    return torch.stack([lo, hi], dim=1).reshape(2 * half, out).to(dtype)


def _dense(x: torch.Tensor, p: Dict[str, torch.Tensor], int4_impl: str = "parity"
           ) -> torch.Tensor:
    """``x @ kernel (+ bias)`` for float, int8 (``kernel_q``) and 4-bit
    (``kernel_q4``, NF4 with ``kernel_cb4``) parameters, with the reference's
    formulations and its dispatch by row count."""
    if "kernel_q4" in p:
        packed = p["kernel_q4"]
        half, out_dim = packed.shape
        in_pad = 2 * half
        cb = p.get("kernel_cb4")
        if x.shape[-1] != in_pad:  # kernel rows were padded to the block grid
            x = F.pad(x, (0, in_pad - x.shape[-1]))  # zero activations x zero rows: exact
        if int4_impl == "kernel":
            rows = math.prod(x.shape[:-1])
            if rows <= 32 and supported(half, out_dim):
                out = int4_matmul(x, packed, p["kernel_scale4"], codebook=cb)
                return out + p["bias"].to(x.dtype) if "bias" in p else out
            int4_impl = "parity" if rows > 32 else "blockdot"
        if cb is not None:  # NF4: codebook lookup in f32, rounded to x's dtype after
            cb32 = cb.to(torch.float32)
            lo = cb32[(packed & 0xF).long()].to(x.dtype)
            hi = cb32[(packed >> 4).long()].to(x.dtype)
        else:
            pk = packed.view(torch.int8)
            lo = (torch.bitwise_left_shift(pk, 4) >> 4).to(x.dtype)  # rows 0, 2, 4, ...
            hi = (pk >> 4).to(x.dtype)                                # rows 1, 3, 5, ...
        scale = p["kernel_scale4"]                                    # [in_pad/64, out]
        nb = scale.shape[0]
        sub = half // nb
        if int4_impl == "blockdot":
            # per-block dots of the raw nibbles in f32; the block scale lands
            # on the [nb, B, out] partial products
            lead = x.shape[:-1]
            xf = x.reshape(-1, in_pad).to(torch.float32)
            xe = xf[:, 0::2].reshape(-1, nb, sub).transpose(0, 1)
            xo = xf[:, 1::2].reshape(-1, nb, sub).transpose(0, 1)
            part = (torch.bmm(xe, lo.to(torch.float32).reshape(nb, sub, out_dim))
                    + torch.bmm(xo, hi.to(torch.float32).reshape(nb, sub, out_dim)))
            out = (part * scale.to(torch.float32)[:, None, :]).sum(0).to(x.dtype)
            out = out.reshape(*lead, out_dim)
        elif int4_impl == "parity":
            # y = x_even @ deq(lo) + x_odd @ deq(hi), the scale applied in x's dtype
            s = scale.to(x.dtype)[:, None, :]
            deq_lo = (lo.reshape(nb, sub, out_dim) * s).reshape(half, out_dim)
            deq_hi = (hi.reshape(nb, sub, out_dim) * s).reshape(half, out_dim)
            out = torch.matmul(x[..., 0::2], deq_lo) + torch.matmul(x[..., 1::2], deq_hi)
        else:
            raise KeyError(f"int4_impl must be parity|blockdot|kernel, got {int4_impl!r}")
    elif "kernel_q" in p:
        kernel = p["kernel_q"].to(x.dtype) * p["kernel_scale"].to(x.dtype)[None, :]
        out = torch.matmul(x, kernel)
    else:
        out = torch.matmul(x, p["kernel"].to(x.dtype))
    if "bias" in p:
        out = out + p["bias"].to(x.dtype)
    return out


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, HF 'half-rotation' layout. x: [B, T, H, D]."""
    d = x.shape[-1]
    inv_freq = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                             device=x.device) / d))
    angles = positions.to(torch.float32)[..., None] * inv_freq      # [B, T, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    xf1, xf2 = x[..., : d // 2].to(torch.float32), x[..., d // 2:].to(torch.float32)
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)


def _kv_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the head dim: [..., hd] -> (int8 [..., hd], f32
    scale [...]), the scale ``max|x| / 127`` and the codes ``round(x /
    max(scale, 1e-12))`` clipped to +-127 (halves to even). Both divisions
    take a tensor divisor, so they round once on the card too."""
    xf = x.to(torch.float32)
    scale = xf.abs().amax(dim=-1) / torch.full((), 127.0, device=x.device)
    q = torch.round(xf / torch.clamp(scale, min=1e-12)[..., None])
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def _cache_alloc(bsz: int, t_cache: int, nkv: int, hd: int, dtype,
                 kv_bits: Optional[int] = None, device=None):
    """Zeroed KV cache for one layer: [B, T, nkv, hd] in the compute dtype, or
    with ``kv_bits == 8`` the quantized form {"q": int8 [B, T, nkv, hd],
    "s": f32 [B, T, nkv]}. Other values of ``kv_bits`` are refused by
    :func:`_check_config`, which every forward runs."""
    if kv_bits == 8:
        return {"q": torch.zeros(bsz, t_cache, nkv, hd, dtype=torch.int8, device=device),
                "s": torch.zeros(bsz, t_cache, nkv, dtype=torch.float32, device=device)}
    return torch.zeros(bsz, t_cache, nkv, hd, dtype=dtype, device=device)


def _cache_write(cache, new: torch.Tensor, *idx):
    """Write compute-dtype K/V rows into the cache at ``idx`` (leading
    batch/token axes, which a quantized cache's scales share), in place;
    returns the cache."""
    if isinstance(cache, dict):
        q, s = _kv_quantize(new)
        cache["q"][idx] = q
        cache["s"][idx] = s
        return cache
    cache[idx] = new.to(cache.dtype)
    return cache


def _probs(logits, valid, config: LlamaConfig, hd: int) -> torch.Tensor:
    """f32 softmax of [B, nh, t, T] logits: scaled, soft-capped (gemma2),
    invalid slots masked with the most negative f32."""
    scale = config.query_pre_attn_scalar if config.query_pre_attn_scalar else hd
    logits = logits / math.sqrt(scale)
    if config.attn_logit_softcapping:
        cap = config.attn_logit_softcapping
        logits = cap * torch.tanh(logits / cap)
    logits = torch.where(valid, logits, torch.finfo(torch.float32).min)
    return torch.softmax(logits, dim=-1)


def _attend(q5, keys, values, valid, config: LlamaConfig, x_dtype) -> torch.Tensor:
    """Softmax attention of [B, t, nkv, group, hd] queries over [B, T, nkv,
    hd] keys/values; f32 logits (the products of the compute dtype's values
    are exact in f32), masked with the most negative f32."""
    bsz, t_new, nkv, group, hd = q5.shape
    logits = torch.einsum("bqngd,bknd->bngqk", q5.to(torch.float32),
                          keys.to(torch.float32)).reshape(bsz, nkv * group, t_new, -1)
    probs = _probs(logits, valid, config, hd).to(x_dtype)
    p5 = probs.reshape(bsz, nkv, group, t_new, -1)
    return torch.einsum("bngqk,bknd->bqngd", p5, values).reshape(bsz, t_new, nkv * group * hd)


def _attend_quantized(q5, k_cache, v_cache, k, v, valid, config: LlamaConfig, x_dtype
                      ) -> torch.Tensor:
    """:func:`_attend` over an int8 cache and the new tokens' K/V, with the
    reference's arithmetic: the cache slots and the new slots are scored
    apart and concatenated; the raw codes, cast to the compute dtype, are
    contracted in f32 and each slot's K scale multiplies its logits after
    the contraction; each slot's V scale is folded into the probabilities,
    which are cast to the compute dtype before the product with the raw
    codes. The dequantized cache never exists. The codes (at most 127 in
    magnitude) convert exactly to the compute dtype, so they go to f32 in one
    step."""
    bsz, t_q, nkv, group, hd = q5.shape
    t_cache = k_cache["q"].shape[1]
    t_all = t_cache + k.shape[1]
    f32 = torch.float32
    qf = q5.to(f32)
    lg_c = torch.einsum("bqngd,bknd->bngqk", qf, k_cache["q"].to(f32))
    lg_c = lg_c * k_cache["s"].transpose(1, 2)[:, :, None, None, :]
    lg_n = torch.einsum("bqngd,bknd->bngqk", qf, k.to(f32))
    logits = torch.cat([lg_c, lg_n], dim=-1).reshape(bsz, nkv * group, t_q, t_all)
    p5 = _probs(logits, valid, config, hd).reshape(bsz, nkv, group, t_q, t_all)
    pc = p5[..., :t_cache] * v_cache["s"].transpose(1, 2)[:, :, None, None, :]
    ctx = torch.einsum("bngqk,bknd->bqngd", pc.to(x_dtype).to(f32),
                       v_cache["q"].to(f32))
    ctx = ctx + torch.einsum("bngqk,bknd->bqngd", p5[..., t_cache:].to(x_dtype).to(f32),
                             v.to(f32))
    return ctx.to(x_dtype).reshape(bsz, t_q, nkv * group * hd)


def _attention_block(x, layer_p, config: LlamaConfig, positions, k_cache, v_cache,
                     cache_mask, new_mask, cache_positions=None, sliding=False, heads=None,
                     tp=None):
    """Attend new tokens (x) against cache+self. Returns (out, new_k, new_v).

    k_cache/v_cache: [B, T_cache, n_kv, hd], or the int8 form of
    :func:`_cache_alloc`; ``cache_mask`` [B, T_cache] marks written cache
    slots, ``new_mask`` [B, T_new] valid (non-pad) new tokens. New tokens
    attend cache slots per cache_mask and each other causally AND per
    new_mask. GQA splits the query-head axis (kv head n serves query heads
    [n*group, (n+1)*group)); the cache is never repeated. Long inputs run
    PREFILL_QUERY_CHUNK queries at a time. ``heads``: this rank's (query, KV)
    heads under tensor parallelism over ``tp``, whose ranks' o_proj partial
    sums are added.
    """
    bsz, t_new, _ = x.shape
    nh, nkv = heads or (config.num_attention_heads, config.num_key_value_heads)
    hd = config.head_dim
    q = _dense(x, layer_p["q_proj"], config.int4_impl).reshape(bsz, t_new, nh, hd)
    k = _dense(x, layer_p["k_proj"], config.int4_impl).reshape(bsz, t_new, nkv, hd)
    v = _dense(x, layer_p["v_proj"], config.int4_impl).reshape(bsz, t_new, nkv, hd)
    q = _rope(q, positions, config.rope_theta)
    k = _rope(k, positions, config.rope_theta)

    quantized = isinstance(k_cache, dict)
    t_cache = (k_cache["q"] if quantized else k_cache).shape[1]
    if quantized:
        def attend(qc, vc):
            return _attend_quantized(qc, k_cache, v_cache, k, v, vc, config, x.dtype)
    else:
        keys = torch.cat([k_cache, k], dim=1).to(x.dtype)
        values = torch.cat([v_cache, v], dim=1).to(x.dtype)

        def attend(qc, vc):
            return _attend(qc, keys, values, vc, config, x.dtype)
    q5 = q.reshape(bsz, t_new, nkv, nh // nkv, hd)
    cache_valid = cache_mask.bool()[:, None, None, :].expand(bsz, 1, t_new, t_cache)
    causal = torch.tril(torch.ones(t_new, t_new, dtype=torch.bool, device=x.device))
    new_valid = (causal[None, None] & new_mask.bool()[:, None, None, :]).expand(
        bsz, 1, t_new, t_new)
    valid = torch.cat([cache_valid, new_valid], dim=-1)
    if sliding and config.sliding_window:
        # gemma2 local attention: the key's position within the window of the query's
        if cache_positions is None:
            cache_positions = torch.zeros(bsz, t_cache, dtype=positions.dtype,
                                          device=x.device)
        key_pos = torch.cat([cache_positions, positions], dim=1)
        delta = positions[:, :, None] - key_pos[:, None, :]
        valid = valid & (delta < config.sliding_window)[:, None, :, :]
    ctx = torch.cat([attend(q5[:, s:s + PREFILL_QUERY_CHUNK],
                            valid[:, :, s:s + PREFILL_QUERY_CHUNK])
                     for s in range(0, t_new, PREFILL_QUERY_CHUNK)], dim=1)
    return _tp_sum(_dense(ctx, layer_p["o_proj"], config.int4_impl), tp), k, v


def llama_block_forward(params: Params, input_ids, positions, config: LlamaConfig,
                        k_caches, v_caches, cache_mask, new_mask=None,
                        compute_dtype=torch.float32, cache_positions=None):
    """Forward ``t_new`` tokens given per-layer caches; returns (logits [B,
    t_new, V] f32, new_ks, new_vs). The llama family (pre-norm, SwiGLU) and
    gemma2 (sandwich norms, GeGLU, soft-capping, alternating sliding-window
    attention)."""
    _check_config(config)
    g2 = config.is_gemma2
    x = params["embed_tokens"][input_ids].to(compute_dtype)
    if g2:  # gemma scales embeddings by sqrt(hidden)
        x = x * torch.tensor(math.sqrt(config.hidden_size), dtype=compute_dtype)
    if new_mask is None:
        new_mask = torch.ones(input_ids.shape, dtype=torch.int32, device=input_ids.device)
    eps = config.rms_norm_eps
    tp, heads = params.get("tp"), _local_heads(params, config)
    new_ks, new_vs = [], []
    for li, layer_p in enumerate(params["layers"]):
        # gemma2 applies the sliding window on even layers (HF: not bool(li % 2))
        sliding = g2 and config.sliding_window is not None and li % 2 == 0
        h = _rms_norm(x, layer_p["input_layernorm"]["scale"], eps, plus_one=g2)
        attn, nk, nv = _attention_block(h, layer_p, config, positions, k_caches[li],
                                        v_caches[li], cache_mask, new_mask,
                                        cache_positions=cache_positions, sliding=sliding,
                                        heads=heads, tp=tp)
        new_ks.append(nk)
        new_vs.append(nv)
        if g2:
            attn = _rms_norm(attn, layer_p["post_attention_layernorm"]["scale"], eps,
                             plus_one=True)
            x = x + attn
            h = _rms_norm(x, layer_p["pre_feedforward_layernorm"]["scale"], eps,
                          plus_one=True)
        else:
            x = x + attn
            h = _rms_norm(x, layer_p["post_attention_layernorm"]["scale"], eps)
        gate = _dense(h, layer_p["gate_proj"], config.int4_impl)
        up = _dense(h, layer_p["up_proj"], config.int4_impl)
        if config.hidden_activation == "gelu_pytorch_tanh":
            act = F.gelu(gate.to(torch.float32), approximate="tanh")
        else:
            act = F.silu(gate.to(torch.float32))
        mlp = _tp_sum(_dense(act.to(x.dtype) * up, layer_p["down_proj"], config.int4_impl), tp)
        if g2:
            mlp = _rms_norm(mlp, layer_p["post_feedforward_layernorm"]["scale"], eps,
                            plus_one=True)
        x = x + mlp
    x = _rms_norm(x, params["norm"]["scale"], eps, plus_one=g2)
    if config.tie_word_embeddings:
        logits = torch.einsum("bth,vh->btv", x.to(torch.float32),
                              params["embed_tokens"].to(torch.float32))
    else:
        logits = _tp_gather_vocab(_dense(x, params["lm_head"], config.int4_impl), tp)
        logits = logits.to(torch.float32)
    if config.final_logit_softcapping:
        cap = config.final_logit_softcapping
        logits = cap * torch.tanh(logits / cap)
    return logits, new_ks, new_vs


# ----------------------------------------------------------------- decode


def _prefill_state(params, input_ids, attention_mask, config, total_new_tokens,
                   compute_dtype, eos_token_id):
    """Run the prompt, preallocate caches with room for ``total_new_tokens``,
    and return (first_token, first_logits, decode-state dict). ``pending`` is
    the latest generated token, already counted in the output but not yet
    fed; ``write_at`` is where its K/V will be written."""
    bsz, t_prompt = input_ids.shape
    nkv, hd, nl = _local_heads(params, config)[1], config.head_dim, config.num_hidden_layers
    device = input_ids.device
    t_cache = t_prompt + total_new_tokens
    # positions: left padding -> clip(cumsum(mask) - 1, 0)
    positions = torch.clamp(torch.cumsum(attention_mask, dim=1) - 1, min=0)
    kv_bits = config.kv_quant_bits
    empty = [_cache_alloc(bsz, 0, nkv, hd, compute_dtype, kv_bits, device) for _ in range(nl)]
    empty_mask = torch.zeros(bsz, 0, dtype=attention_mask.dtype, device=device)
    empty_pos = torch.zeros(bsz, 0, dtype=positions.dtype, device=device)
    logits, new_ks, new_vs = llama_block_forward(
        params, input_ids, positions, config, empty, empty, empty_mask,
        new_mask=attention_mask, compute_dtype=compute_dtype, cache_positions=empty_pos)

    def alloc(new):
        cache = _cache_alloc(bsz, t_cache, nkv, hd, compute_dtype, kv_bits, device)
        return _cache_write(cache, new, slice(None), slice(0, t_prompt))

    next_token = torch.argmax(logits[:, -1], dim=-1)
    done0 = (torch.zeros(bsz, dtype=torch.bool, device=device) if eos_token_id is None
             else next_token == eos_token_id)
    state = {
        "k": [alloc(k) for k in new_ks],
        "v": [alloc(v) for v in new_vs],
        "cache_mask": F.pad(attention_mask, (0, total_new_tokens)),
        "cache_pos": F.pad(positions, (0, total_new_tokens)),
        "pending": next_token,
        "pos": positions[:, -1] + 1,
        "done": done0,
        "write_at": t_prompt,
    }
    return next_token, logits[:, -1], state


def _decode_step(params, state, config, compute_dtype, eos_token_id):
    """Feed the pending token, write its K/V at ``write_at`` (in place),
    greedy-pick the next. Returns (logits [B, V] of the fed token, state)."""
    token, pos = state["pending"], state["pos"]
    lg, nk, nv = llama_block_forward(
        params, token[:, None], pos[:, None], config, state["k"], state["v"],
        state["cache_mask"], compute_dtype=compute_dtype,
        cache_positions=state["cache_pos"])
    w = state["write_at"]
    new_token = torch.argmax(lg[:, -1], dim=-1)
    done = state["done"]
    if eos_token_id is not None:
        new_token = torch.where(done, torch.full_like(new_token, eos_token_id), new_token)
        done = done | (new_token == eos_token_id)
    for cache, new in zip(state["k"] + state["v"], nk + nv):
        _cache_write(cache, new[:, 0], slice(None), w)
    state["cache_mask"][:, w] = 1
    state["cache_pos"][:, w] = pos
    state.update(pending=new_token, pos=pos + 1, done=done, write_at=w + 1)
    return lg[:, -1], state


def _to_device(input_ids, attention_mask, device):
    ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long, device=device)
    mask = torch.as_tensor(np.asarray(attention_mask), dtype=torch.long, device=device)
    return ids, mask


def _params_device(params: Params) -> torch.device:
    return params["embed_tokens"].device


def greedy_decode(params: Params, input_ids, attention_mask, config: LlamaConfig,
                  max_new_tokens: int, compute_dtype=torch.float32,
                  eos_token_id: Optional[int] = None, return_logits: bool = True
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Prefill + greedy decode of left-padded inputs. Returns (generated ids
    [B, max_new], per-step logits [B, max_new, V] f32, or None with
    ``return_logits=False``). Rows that emit ``eos_token_id`` keep emitting
    it. Without logits the loop stops once every row is done: the remaining
    ids are eos, as the full loop would give."""
    ids, mask = _to_device(input_ids, attention_mask, _params_device(params))
    with torch.inference_mode():
        next_token, first_logits, state = _prefill_state(
            params, ids, mask, config, max_new_tokens, compute_dtype, eos_token_id)
        return _greedy_steps(params, state, first_logits, config, max_new_tokens,
                             compute_dtype, eos_token_id, return_logits)


def _greedy_steps(params, state, first_logits, config, max_new_tokens, compute_dtype,
                  eos_token_id, return_logits):
    """The decode loop after a prefill: (ids [B, max_new] int32, logits [B,
    max_new, V] | None), the first token and its logits the prefill's.
    Without logits the loop stops once every row is done."""
    next_token = state["pending"]
    tokens, logits = [next_token], [first_logits]
    for _ in range(max_new_tokens - 1):
        if not return_logits and eos_token_id is not None and bool(state["done"].all()):
            tokens.append(torch.full_like(next_token, eos_token_id))
            continue
        lg, state = _decode_step(params, state, config, compute_dtype, eos_token_id)
        tokens.append(state["pending"])
        if return_logits:
            logits.append(lg)
    gen_ids = torch.stack(tokens, dim=1).to(torch.int32)
    return gen_ids, (torch.stack(logits, dim=1) if return_logits else None)


def prefill_decode(params: Params, input_ids, attention_mask, config: LlamaConfig,
                   total_new_tokens: int, compute_dtype=torch.float32,
                   eos_token_id: Optional[int] = None):
    """Prefill once, emit the FIRST generated token, return a resumable state
    (the KV-cache-resumable half of segmented decoding): (ids [B, 1], logits
    [B, 1, V], state)."""
    ids, mask = _to_device(input_ids, attention_mask, _params_device(params))
    with torch.inference_mode():
        next_token, first_logits, state = _prefill_state(
            params, ids, mask, config, total_new_tokens, compute_dtype, eos_token_id)
    return next_token[:, None].to(torch.int32), first_logits[:, None], state


def resume_decode(params: Params, state, config: LlamaConfig, n_steps: int,
                  compute_dtype=torch.float32, eos_token_id: Optional[int] = None,
                  return_logits: bool = True):
    """Continue greedy decoding ``n_steps`` tokens from a prefill/resume
    state, which is updated in place. Returns (ids [B, n_steps], logits [B,
    n_steps, V] | None, state); prefill + resume outputs concatenated equal
    :func:`greedy_decode`'s."""
    tokens, logits = [], []
    with torch.inference_mode():
        for _ in range(n_steps):
            lg, state = _decode_step(params, state, config, compute_dtype, eos_token_id)
            tokens.append(state["pending"])
            if return_logits:
                logits.append(lg)
    ids = torch.stack(tokens, dim=1).to(torch.int32)
    return ids, (torch.stack(logits, dim=1) if return_logits else None), state


# ----------------------------------------------------------------- prefix KV pool
#
# The KiRAG constructor renders (instruction + ranked examplars + question) at
# the head of every turn's prompt. The pool caches each group's prefix K/V
# once, [n_groups, PB, ...] per layer in the cache format, and a later call
# prefills only each row's suffix. Matching is by the longest common token
# prefix with the cached ids (numpy, on the host), so a cached tail that a
# prompt diverges from is never attended.


def alloc_prefix_pool(config: LlamaConfig, n_groups: int, prefix_len: int,
                      compute_dtype=torch.bfloat16, device=None, params: Optional[Params] = None):
    """Zeroed per-layer prefix K/V pools, [n_groups, prefix_len, nkv, hd] in
    the cache format (int8 codes and f32 scales with ``kv_quant_bits=8``),
    on ``device`` (default: the GPU); ``nkv`` is the KV heads of ``params``
    (this rank's of a sharded tree), by default the config's."""
    _check_config(config)
    device = _entry_device(device)
    nkv = config.num_key_value_heads if params is None else _local_heads(params, config)[1]
    hd, nl = config.head_dim, config.num_hidden_layers

    def alloc():
        return [_cache_alloc(n_groups, prefix_len, nkv, hd, compute_dtype, config.kv_quant_bits,
                             device) for _ in range(nl)]

    with torch.inference_mode():
        return {"k": alloc(), "v": alloc()}


def write_prefix_pool(params: Params, pool, slot: int, prefix_ids, prefix_mask,
                      config: LlamaConfig, compute_dtype=torch.bfloat16):
    """Prefill one RIGHT-padded prefix ([1, PB] ids + mask, positions
    ``clip(cumsum(mask) - 1, 0)``) and write its K/V into pool slot
    ``slot``, in place. Returns the pool."""
    ids, mask = _to_device(prefix_ids, prefix_mask, _params_device(params))
    positions = torch.clamp(torch.cumsum(mask, dim=1) - 1, min=0)
    bsz = ids.shape[0]
    nkv, hd, nl = _local_heads(params, config)[1], config.head_dim, config.num_hidden_layers
    with torch.inference_mode():
        empty = [_cache_alloc(bsz, 0, nkv, hd, compute_dtype, config.kv_quant_bits, ids.device)
                 for _ in range(nl)]
        _, ks, vs = llama_block_forward(
            params, ids, positions, config, empty, empty, mask[:, :0], new_mask=mask,
            compute_dtype=compute_dtype, cache_positions=positions[:, :0])
        for cache, new in zip(pool["k"] + pool["v"], ks + vs):
            _cache_write(cache, new[0], slot)
    return pool


def _gather_slots(pool_layer, slot_idx, width: int):
    """The first ``width`` slots of each row's pool slot (``slot_idx`` [B])."""
    if isinstance(pool_layer, dict):
        return {"q": pool_layer["q"][slot_idx, :width], "s": pool_layer["s"][slot_idx, :width]}
    return pool_layer[slot_idx, :width]


def _prefixed_prefill_state(params, pool, slot_idx, match_len, suffix_ids, suffix_mask,
                            config, total_new_tokens, compute_dtype, eos_token_id,
                            prefix_window: Optional[int] = None):
    """Prefill LEFT-padded suffixes against per-row cached prefixes.

    ``slot_idx`` [B] picks each row's pool slot; ``match_len`` [B] counts
    its valid cached slots (its longest common token prefix with the cached
    ids: the slots past it hold another call's tail and are masked out).
    Suffix positions are ``match_len + clip(cumsum(mask) - 1, 0)``.
    ``prefix_window`` (>= every match_len) keeps the first ``prefix_window``
    pool slots, so the decode cache spans about the prompt, not the pool."""
    bsz, t_suf = suffix_ids.shape
    first = pool["k"][0]
    pb = (first["q"] if isinstance(first, dict) else first).shape[1]
    if prefix_window is not None:
        pb = min(pb, prefix_window)
    nkv, hd = _local_heads(params, config)[1], config.head_dim
    device = suffix_ids.device
    t_cache = pb + t_suf + total_new_tokens
    pk = [_gather_slots(p, slot_idx, pb) for p in pool["k"]]
    pv = [_gather_slots(p, slot_idx, pb) for p in pool["v"]]
    slots = torch.arange(pb, device=device)
    prefix_mask = (slots[None, :] < match_len[:, None]).to(suffix_mask.dtype)
    prefix_pos = slots[None, :].expand(bsz, pb)
    positions = match_len[:, None] + torch.clamp(torch.cumsum(suffix_mask, dim=1) - 1, min=0)
    logits, new_ks, new_vs = llama_block_forward(
        params, suffix_ids, positions, config, pk, pv, prefix_mask, new_mask=suffix_mask,
        compute_dtype=compute_dtype, cache_positions=prefix_pos)

    def alloc(prefix_entry, new):
        cache = _cache_alloc(bsz, t_cache, nkv, hd, compute_dtype, config.kv_quant_bits, device)
        if isinstance(cache, dict):
            cache["q"][:, :pb] = prefix_entry["q"]
            cache["s"][:, :pb] = prefix_entry["s"]
        else:
            cache[:, :pb] = prefix_entry
        return _cache_write(cache, new, slice(None), slice(pb, pb + t_suf))

    next_token = torch.argmax(logits[:, -1], dim=-1)
    done0 = (torch.zeros(bsz, dtype=torch.bool, device=device) if eos_token_id is None
             else next_token == eos_token_id)
    state = {
        "k": [alloc(p, k) for p, k in zip(pk, new_ks)],
        "v": [alloc(p, v) for p, v in zip(pv, new_vs)],
        "cache_mask": F.pad(torch.cat([prefix_mask, suffix_mask], dim=1), (0, total_new_tokens)),
        "cache_pos": F.pad(torch.cat([prefix_pos, positions], dim=1), (0, total_new_tokens)),
        "pending": next_token,
        "pos": positions[:, -1] + 1,
        "done": done0,
        "write_at": pb + t_suf,
    }
    return next_token, logits[:, -1], state


def greedy_decode_prefixed(params: Params, pool, slot_idx, match_len, suffix_ids, suffix_mask,
                           config: LlamaConfig, max_new_tokens: int, compute_dtype=torch.float32,
                           eos_token_id: Optional[int] = None, return_logits: bool = True,
                           prefix_window: Optional[int] = None):
    """:func:`greedy_decode` against per-row cached prefixes, with its
    output contract on the equivalent full prompts (ids equal; logits to
    the rounding of the sums' order). ``prefix_window``: see
    :func:`_prefixed_prefill_state`."""
    device = _params_device(params)
    ids, mask = _to_device(suffix_ids, suffix_mask, device)
    slot_idx, match_len = _to_device(slot_idx, match_len, device)
    with torch.inference_mode():
        _, first_logits, state = _prefixed_prefill_state(
            params, pool, slot_idx, match_len, ids, mask, config, max_new_tokens,
            compute_dtype, eos_token_id, prefix_window=prefix_window)
        return _greedy_steps(params, state, first_logits, config, max_new_tokens,
                             compute_dtype, eos_token_id, return_logits)


# ----------------------------------------------------------------- backend


class TorchLlamaBackend:
    """Token-level greedy backend of the Generator harness, with the
    reference's prompt buckets (left-pad up to a bucket, left-truncate past
    the largest). numpy in, numpy out.

    ``config.kv_quant_bits == 8`` keeps the decode cache in int8.
    ``draft_params``/``draft_config`` switch decoding to greedy speculative
    decoding (:mod:`kirag_tpu_torch.models.speculative`): the draft proposes
    ``spec_gamma - 1`` tokens a round, the target verifies them in one
    forward, and the stream is plain greedy's. Both models share the vocab,
    and the cache stays full-precision. Segmented decode with logits takes
    the plain path (the speculative resume carries no logits).
    ``prefix_cache_groups`` > 0 keeps a pool of that many prefixes'
    K/V (``prefix_cache_tokens`` each, allocated at the first prefixed
    call) for ``greedy(..., prefix_groups=...)``; not with a draft."""

    def __init__(self, params: Params, config: LlamaConfig, eos_token_id: int,
                 compute_dtype=torch.bfloat16,
                 prompt_buckets=(128, 256, 512, 1024, 2048, 4096),
                 draft_params: Optional[Params] = None,
                 draft_config: Optional[LlamaConfig] = None, spec_gamma: int = 4,
                 prefix_cache_groups: int = 0, prefix_cache_tokens: int = 2048):
        _check_config(config)
        self.params = params
        self.config = config
        self.eos_token_id = eos_token_id
        self.compute_dtype = compute_dtype
        self.prompt_buckets = prompt_buckets
        # prefix pool: groups x tokens x 2 x nkv x hd x layers x (1-2 bytes)
        self.prefix_cache_groups = prefix_cache_groups
        self.prefix_cache_tokens = prefix_cache_tokens
        self._prefix_pool = None
        self._prefix_meta = {}      # group -> {"slot": int, "ids": np [P]}
        self._prefix_lru = []       # groups, least recently used first
        if draft_params is not None:
            from kirag_tpu_torch.models.speculative import check_full_precision_cache

            if draft_config is None:
                raise ValueError("draft_params needs draft_config")
            if draft_config.vocab_size != config.vocab_size:
                raise ValueError("draft and target must share the tokenizer/vocab")
            _check_config(draft_config)
            check_full_precision_cache(config, draft_config)
        self.draft_params = draft_params
        self.draft_config = draft_config
        self.spec_gamma = spec_gamma
        # spec_acc_hist[a]: (row, round) pairs that accepted exactly a drafts,
        # summed over every call; read from the device once a call.
        # draft_script_fn(input_ids, attention_mask) may return a [B, W]
        # proposal script (see models.speculative._spec_round) or None
        self.spec_acc_hist = np.zeros((spec_gamma,), np.int64)
        self.draft_script_fn = None

    def _bucket(self, t: int) -> int:
        for b in self.prompt_buckets:
            if b >= t:
                return b
        return self.prompt_buckets[-1]

    def _bucket_inputs(self, input_ids: np.ndarray, attention_mask: np.ndarray):
        t = input_ids.shape[1]
        bucket = self._bucket(t)
        if bucket > t:  # extend LEFT padding to the bucket
            pad = bucket - t
            input_ids = np.pad(input_ids, ((0, 0), (pad, 0)))
            attention_mask = np.pad(attention_mask, ((0, 0), (pad, 0)))
        elif bucket < t:  # prompt longer than the largest bucket: truncate left
            input_ids = input_ids[:, -bucket:]
            attention_mask = attention_mask[:, -bucket:]
        return input_ids, attention_mask

    @staticmethod
    def _numpy(ids, logits):
        return (ids.cpu().numpy().astype(np.int32),
                None if logits is None else logits.float().cpu().numpy())

    def _spec_args(self):
        return (self.params, self.config, self.draft_params, self.draft_config)

    def _draft_script(self, input_ids, attention_mask):
        return (None if self.draft_script_fn is None
                else self.draft_script_fn(input_ids, attention_mask))

    def shard_params(self, mesh, model_axis: str = "model") -> "TorchLlamaBackend":
        """Keep this rank's part of the target's and the draft's params over
        ``mesh[model_axis]`` (:func:`shard_llama_params`; port of
        ``JaxLlamaBackend.shard_params``). Every later decode is a
        collective over that axis: each of its ranks calls it with the same
        inputs. Each projection keeps its formulation: 4-bit kernels run K6
        on their shard (the reference falls back to its XLA formulation,
        since its Pallas kernel is opaque to the partitioner)."""
        self.params = shard_llama_params(self.params, self.config, mesh, model_axis)
        if self.draft_params is not None:
            self.draft_params = shard_llama_params(self.draft_params, self.draft_config, mesh,
                                                   model_axis)
        return self

    # -- prefix KV pool

    @property
    def supports_prefix_cache(self) -> bool:
        # speculative decoding verifies over a fed window; prefixed reuse is
        # the plain greedy path only, as in the reference
        return self.prefix_cache_groups > 0 and self.draft_params is None

    def _prefix_slot(self, group, row_ids: np.ndarray) -> dict:
        """The pool slot of ``group``; a new group takes a free slot or the
        least recently used one, seeded with ``row_ids[:prefix_cache_tokens]``."""
        meta = self._prefix_meta.get(group)
        if meta is None:
            if len(self._prefix_meta) >= self.prefix_cache_groups:
                meta = self._prefix_meta.pop(self._prefix_lru.pop(0))
                slot = meta["slot"]
            else:
                slot = len(self._prefix_meta)
            pb = self.prefix_cache_tokens
            ids = np.asarray(row_ids[:pb], dtype=np.int32)
            padded = np.zeros((1, pb), np.int32)
            padded[0, :len(ids)] = ids                    # RIGHT padding
            mask = np.zeros((1, pb), np.int32)
            mask[0, :len(ids)] = 1
            if self._prefix_pool is None:
                self._prefix_pool = alloc_prefix_pool(self.config, self.prefix_cache_groups, pb,
                                                      self.compute_dtype,
                                                      _params_device(self.params), self.params)
            write_prefix_pool(self.params, self._prefix_pool, slot, padded, mask, self.config,
                              self.compute_dtype)
            meta = {"slot": slot, "ids": ids}
            self._prefix_meta[group] = meta
        if group in self._prefix_lru:
            self._prefix_lru.remove(group)
        self._prefix_lru.append(group)
        return meta

    def _greedy_prefixed(self, input_ids: np.ndarray, attention_mask: np.ndarray,
                         prefix_groups, max_new_tokens: int, return_logits: bool):
        """Each row reuses its longest common prefix with its group's cached
        ids (none under 16 tokens) and keeps one suffix token at least, so
        that the prefill gives logits."""
        rows = [ids[m.astype(bool)] for ids, m in
                zip(np.asarray(input_ids), np.asarray(attention_mask))]
        slots, matches, suffixes = [], [], []
        for row, group in zip(rows, prefix_groups):
            meta = self._prefix_slot(group, row)
            cached = meta["ids"]
            n = min(len(row) - 1, len(cached))
            same = row[:n] == cached[:n]
            m = n if same.all() else int(np.argmin(same))
            if m < 16:  # not worth a prefixed prefill
                m = 0
            slots.append(meta["slot"])
            matches.append(m)
            suffixes.append(row[m:])
        t_suf = self._bucket(max(len(x) for x in suffixes))
        suf_ids = np.zeros((len(rows), t_suf), np.int32)
        suf_mask = np.zeros((len(rows), t_suf), np.int32)
        for r, x in enumerate(suffixes):
            x = x[-t_suf:]                                # truncate left if huge
            suf_ids[r, t_suf - len(x):] = x               # LEFT padding
            suf_mask[r, t_suf - len(x):] = 1
        # the window in 256-slot steps: the decode cache spans about the
        # prompt instead of the whole pool
        window = min(self.prefix_cache_tokens, max(256, -(-max(matches) // 256) * 256))
        ids, logits = greedy_decode_prefixed(
            self.params, self._prefix_pool, np.asarray(slots), np.asarray(matches), suf_ids,
            suf_mask, self.config, max_new_tokens, self.compute_dtype,
            eos_token_id=self.eos_token_id, return_logits=return_logits, prefix_window=window)
        return self._numpy(ids, logits)

    # -- decoding

    def greedy(self, input_ids: np.ndarray, attention_mask: np.ndarray,
               max_new_tokens: int, return_logits: bool = True, prefix_groups=None
               ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        if prefix_groups is not None and self.supports_prefix_cache:
            return self._greedy_prefixed(input_ids, attention_mask, prefix_groups,
                                         max_new_tokens, return_logits)
        input_ids, attention_mask = self._bucket_inputs(input_ids, attention_mask)
        if self.draft_params is not None:
            from kirag_tpu_torch.models.speculative import speculative_decode

            ids, logits, hist = speculative_decode(
                *self._spec_args(), input_ids, attention_mask, max_new_tokens,
                gamma=self.spec_gamma, compute_dtype=self.compute_dtype,
                eos_token_id=self.eos_token_id, return_logits=return_logits,
                draft_script=self._draft_script(input_ids, attention_mask), return_stats=True)
            self.spec_acc_hist += hist.cpu().numpy()
        else:
            ids, logits = greedy_decode(self.params, input_ids, attention_mask, self.config,
                                        max_new_tokens, self.compute_dtype,
                                        eos_token_id=self.eos_token_id,
                                        return_logits=return_logits)
        return self._numpy(ids, logits)

    def greedy_start(self, input_ids: np.ndarray, attention_mask: np.ndarray,
                     total_new_tokens: int, return_logits: bool = True):
        """Prefill + first token; reserves cache room for ``total_new_tokens``.
        Returns (ids [B, 1], logits [B, 1, V] | None, device-resident state).
        With a draft and no logits the state is the speculative tuple
        ``(state, total_new_tokens, script, acc_hist so far)``."""
        input_ids, attention_mask = self._bucket_inputs(input_ids, attention_mask)
        if self.draft_params is not None and not return_logits:
            from kirag_tpu_torch.models.speculative import speculative_start

            script = self._draft_script(input_ids, attention_mask)
            ids, st = speculative_start(*self._spec_args(), input_ids, attention_mask,
                                        total_new_tokens, gamma=self.spec_gamma,
                                        compute_dtype=self.compute_dtype,
                                        eos_token_id=self.eos_token_id)
            # the state's histogram counts from the start, so each resume
            # adds its difference to the last one seen (rounds run only in
            # resumes)
            return (ids.cpu().numpy(), None,
                    (st, total_new_tokens, script, np.zeros((self.spec_gamma,), np.int64)))
        ids, logits, state = prefill_decode(self.params, input_ids, attention_mask,
                                            self.config, total_new_tokens,
                                            self.compute_dtype, eos_token_id=self.eos_token_id)
        ids, logits = self._numpy(ids, logits if return_logits else None)
        return ids, logits, state

    def greedy_resume(self, state, n_steps: int, return_logits: bool = True):
        """Decode ``n_steps`` more tokens from a greedy_start/resume state (no
        re-prefill; the KV cache stays on the device)."""
        if isinstance(state, tuple) and "served" in state[0]:
            from kirag_tpu_torch.models.speculative import speculative_resume

            st, total, script, hist_prev = state
            ids, st = speculative_resume(*self._spec_args(), st, n_steps, total,
                                         gamma=self.spec_gamma, compute_dtype=self.compute_dtype,
                                         eos_token_id=self.eos_token_id, draft_script=script)
            hist = st["acc_hist"].cpu().numpy()
            self.spec_acc_hist += hist - hist_prev
            return ids.cpu().numpy(), None, (st, total, script, hist)
        ids, logits, state = resume_decode(self.params, state, self.config, n_steps,
                                           self.compute_dtype, eos_token_id=self.eos_token_id,
                                           return_logits=return_logits)
        ids, logits = self._numpy(ids, logits)
        return ids, logits, state


# ----------------------------------------------------------------- checkpoints


def convert_hf_llama_state_dict(state_dict: Dict[str, Any], config: LlamaConfig,
                                int8_weights: bool = False, quant_bits: Optional[int] = None,
                                int4_codebook: str = "nf4", device=None) -> Params:
    """Map an HF llama state_dict to the reference's parameter layout, on
    ``device`` (default: the tensors' own). With ``int8_weights`` (or
    ``quant_bits`` in {4, 8}) each projection kernel is quantized as it is
    converted; ``quant_bits=4`` uses NF4 unless ``int4_codebook="linear"``."""
    if int8_weights and quant_bits is None:
        quant_bits = 8
    quantize = _quantizer(quant_bits, int4_codebook)

    def tensor(name):
        t = torch.as_tensor(np.asarray(state_dict[name]) if not torch.is_tensor(
            state_dict[name]) else state_dict[name])
        return t.to(device) if device is not None else t

    sd = {k.removeprefix("model."): k for k in state_dict}

    def get(name):
        return tensor(sd[name])

    def lin(prefix):
        kernel = get(f"{prefix}.weight").to(torch.float32).T
        p = quantize(kernel) if quantize is not None else {"kernel": kernel.contiguous()}
        if f"{prefix}.bias" in sd:
            p["bias"] = get(f"{prefix}.bias")
        return p

    params: Params = {"embed_tokens": get("embed_tokens.weight"),
                      "norm": {"scale": get("norm.weight")}, "layers": []}
    if not config.tie_word_embeddings:
        params["lm_head"] = lin("lm_head")
    for l in range(config.num_hidden_layers):
        pre = f"layers.{l}"
        layer = {
            "input_layernorm": {"scale": get(f"{pre}.input_layernorm.weight")},
            "post_attention_layernorm": {"scale": get(f"{pre}.post_attention_layernorm.weight")},
            "q_proj": lin(f"{pre}.self_attn.q_proj"),
            "k_proj": lin(f"{pre}.self_attn.k_proj"),
            "v_proj": lin(f"{pre}.self_attn.v_proj"),
            "o_proj": lin(f"{pre}.self_attn.o_proj"),
            "gate_proj": lin(f"{pre}.mlp.gate_proj"),
            "up_proj": lin(f"{pre}.mlp.up_proj"),
            "down_proj": lin(f"{pre}.mlp.down_proj"),
        }
        for extra in ("pre_feedforward_layernorm", "post_feedforward_layernorm"):
            if f"{pre}.{extra}.weight" in sd:  # gemma2 sandwich norms
                layer[extra] = {"scale": get(f"{pre}.{extra}.weight")}
        params["layers"].append(layer)
    return params


def _cast_tree(node, compute_dtype):
    """2-D float tensors (the big ones) to ``compute_dtype``; quantized
    kernels, ``kernel_scale4`` and 1-D leaves (norms, biases, scales) as they
    are."""
    if isinstance(node, dict):
        return {k: (v if k == "kernel_scale4" else _cast_tree(v, compute_dtype))
                for k, v in node.items()}
    if isinstance(node, list):
        return [_cast_tree(v, compute_dtype) for v in node]
    if node.is_floating_point() and node.dim() >= 2:
        return node.to(compute_dtype)
    return node


def load_llama(model_name_or_path: str, compute_dtype=torch.bfloat16,
               int8_weights: bool = False, quant_bits: Optional[int] = None,
               kv_quant_bits: Optional[int] = None, int4_codebook: str = "nf4",
               device=None) -> Tuple[Params, LlamaConfig]:
    """Load a Llama-architecture causal LM from a local HF checkpoint
    directory (``config.json`` + ``model.safetensors`` (or its sharded
    index) or ``pytorch_model.bin``) onto ``device`` (default: the GPU),
    quantizing projections there with ``int8_weights``/``quant_bits``. The
    4-bit matmul runs K6 on the GPU (``int4_impl="kernel"``) and the "parity"
    formulation on the CPU. ``kv_quant_bits=8`` stores the decode KV cache in
    int8 (see :attr:`LlamaConfig.kv_quant_bits`)."""
    from kirag_tpu_torch.models.encoders import read_safetensors

    if not os.path.isdir(model_name_or_path):
        raise FileNotFoundError(
            f"{model_name_or_path} is not a local directory; pass the path of a downloaded "
            "checkpoint")
    device = _entry_device(device)
    with open(os.path.join(model_name_or_path, "config.json")) as f:
        config = config_from_hf(json.load(f))
    st_index = os.path.join(model_name_or_path, "model.safetensors.index.json")
    st_single = os.path.join(model_name_or_path, "model.safetensors")
    bin_path = os.path.join(model_name_or_path, "pytorch_model.bin")
    if os.path.exists(st_index):
        with open(st_index) as f:
            weight_map = json.load(f)["weight_map"]
        state_dict: Dict[str, torch.Tensor] = {}
        for shard in sorted(set(weight_map.values())):
            state_dict.update(read_safetensors(os.path.join(model_name_or_path, shard)))
    elif os.path.exists(st_single):
        state_dict = read_safetensors(st_single)
    elif os.path.exists(bin_path):
        state_dict = {k: v.to(torch.float32) for k, v in
                      torch.load(bin_path, map_location="cpu", weights_only=True).items()}
    else:
        raise FileNotFoundError(f"no safetensors/bin weights under {model_name_or_path}")
    params = convert_hf_llama_state_dict(state_dict, config, int8_weights=int8_weights,
                                         quant_bits=quant_bits, int4_codebook=int4_codebook,
                                         device=device)
    del state_dict
    params = _cast_tree(params, compute_dtype)
    if quant_bits == 4:
        config = dataclasses.replace(
            config, int4_impl="kernel" if device.type == "cuda" else "parity")
    if kv_quant_bits is not None:
        config = dataclasses.replace(config, kv_quant_bits=kv_quant_bits)
    _check_config(config)
    return params, config
