"""T5 encoder-decoder LM in PyTorch with greedy decoding (port of
:mod:`kirag_tpu.models.t5`).

Completes the generator family of the reference, whose `Generator` also
accepts ``T5ForConditionalGeneration`` (`generator/generator.py:26,75`).
Architecture: shared embeddings, T5LayerNorm (RMS, no mean subtraction),
relative-position-bucket attention bias (held by layer 0, shared across
layers; bidirectional in the encoder, causal in the decoder), optional gated
activations, NO 1/sqrt(d) attention scaling, and a tied lm_head scaled by
d_model^-0.5 (or an untied one, as Flan-T5's).

Parameters are a dict of tensors in the reference's layout (kernels
``[in, out]``). The arithmetic follows the reference's: attention logits are
float32 products of the compute-dtype q and k, plus a float32 bias, through
a float32 softmax; the relative-position buckets are computed on the host in
float32, where they equal the reference's bit for bit (a one-ulp difference
at a bucket edge would move the bias of a whole diagonal).

Decode: encode once, then one decoder forward a generated token in a Python
loop, each over the positions generated so far (the mask is causal, so the
reference's forward over the whole buffer gives the same logits there), with
no KV cache, as the reference re-runs its decoder every step; one host read
at the end. Entry points (:func:`load_t5`, :func:`t5_params_from_jax`,
:class:`TorchT5Backend`) work on the GPU unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from kirag_tpu_torch.device import require_cuda


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 2048
    num_layers: int = 6
    num_decoder_layers: int = 6
    num_heads: int = 8
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "relu"  # or "gated-gelu"
    decoder_start_token_id: int = 0
    tie_word_embeddings: bool = True

    @property
    def is_gated(self) -> bool:
        return self.feed_forward_proj.startswith("gated")


Params = Dict[str, Any]


def config_from_hf(hf_config) -> T5Config:
    get = (hf_config.get if isinstance(hf_config, dict)
           else lambda k, d=None: getattr(hf_config, k, d))
    return T5Config(
        vocab_size=get("vocab_size"),
        d_model=get("d_model"),
        d_kv=get("d_kv"),
        d_ff=get("d_ff"),
        num_layers=get("num_layers"),
        num_decoder_layers=get("num_decoder_layers") or get("num_layers"),
        num_heads=get("num_heads"),
        relative_attention_num_buckets=get("relative_attention_num_buckets", 32),
        relative_attention_max_distance=get("relative_attention_max_distance", 128),
        layer_norm_epsilon=get("layer_norm_epsilon", 1e-6),
        feed_forward_proj=get("feed_forward_proj", "relu"),
        decoder_start_token_id=get("decoder_start_token_id", 0),
        tie_word_embeddings=bool(get("tie_word_embeddings", True)),
    )


def _entry_device(device) -> torch.device:
    return require_cuda() if device is None else torch.device(device)


# ----------------------------------------------------------------- layers


def _t5_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


def _dense(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, kernel.to(x.dtype))


def _relative_position_bucket(relative_position: torch.Tensor, bidirectional: bool,
                              num_buckets: int, max_distance: int) -> torch.Tensor:
    """HF T5's bucketing (t5 modeling `_relative_position_bucket`) in the
    reference's float32 steps: ``log(float32(rp) / max_exact + 1e-9) /
    log(max_distance / max_exact)``, each divisor a tensor (a division by a
    Python number may multiply by its reciprocal instead), truncated toward
    zero. Call it on the CPU: the card's ``log`` may differ by an ulp."""
    rp = relative_position
    if bidirectional:
        num_buckets //= 2
        bucket = torch.where(rp > 0, num_buckets, 0)
        rp = rp.abs()
    else:
        bucket = torch.zeros_like(rp)
        rp = -torch.clamp(rp, max=0)
    max_exact = num_buckets // 2
    is_small = rp < max_exact

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=rp.device)

    log_ratio = torch.log(rp.to(torch.float32) / f32(max_exact) + f32(1e-9)) / f32(
        np.log(max_distance / max_exact))
    large = max_exact + (log_ratio * f32(num_buckets - max_exact)).to(torch.int32)
    large = torch.clamp(large, max=num_buckets - 1)
    return bucket + torch.where(is_small, rp, large)


def _position_bias(bias_embedding: torch.Tensor, q_pos, k_pos, bidirectional: bool,
                   config: T5Config) -> torch.Tensor:
    """bias_embedding: [num_buckets, num_heads]; returns [1, H, Tq, Tk] float32
    on its device. The buckets are computed on the host."""
    q_pos = torch.as_tensor(q_pos, device="cpu")
    k_pos = torch.as_tensor(k_pos, device="cpu")
    rel = k_pos[None, :] - q_pos[:, None]  # memory - query
    buckets = _relative_position_bucket(
        rel, bidirectional, config.relative_attention_num_buckets,
        config.relative_attention_max_distance)
    bias = bias_embedding[buckets.to(bias_embedding.device)]  # [Tq, Tk, H]
    return bias.permute(2, 0, 1)[None].to(torch.float32)


def _attention(x: torch.Tensor, kv: torch.Tensor, p: Params, config: T5Config,
               bias: Optional[torch.Tensor], mask: torch.Tensor) -> torch.Tensor:
    """T5 attention: no 1/sqrt(d) scaling; additive position bias.

    x: [B, Tq, D] queries; kv: [B, Tk, D] keys/values source;
    bias: [1orB, H, Tq, Tk] float32 or None; mask: [B or 1, 1, Tq or 1, Tk]
    bool. The logits are float32 products of the compute-dtype q and k (the
    reference's ``preferred_element_type=float32``)."""
    b, tq, _ = x.shape
    tk = kv.shape[1]
    h, dkv = config.num_heads, config.d_kv
    q = _dense(x, p["q"]).view(b, tq, h, dkv)
    k = _dense(kv, p["k"]).view(b, tk, h, dkv)
    v = _dense(kv, p["v"]).view(b, tk, h, dkv)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32))
    if bias is not None:
        logits = logits + bias
    logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, tq, h * dkv)
    return _dense(ctx, p["o"])


def _ff(x: torch.Tensor, p: Params, config: T5Config) -> torch.Tensor:
    if config.is_gated:
        act = F.gelu(_dense(x, p["wi_0"]).to(torch.float32), approximate="tanh")
        inner = act.to(x.dtype) * _dense(x, p["wi_1"])
    else:
        inner = torch.relu(_dense(x, p["wi"]))
    return _dense(inner, p["wo"])


def _params_device(params: Params) -> torch.device:
    return params["shared"].device


def _ids(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                           dtype=torch.long, device=device)


def t5_encode(params: Params, input_ids, attention_mask, config: T5Config,
              compute_dtype=torch.float32) -> torch.Tensor:
    """Returns encoder hidden states [B, T, D] in ``compute_dtype``."""
    device = _params_device(params)
    input_ids, attention_mask = _ids(input_ids, device), _ids(attention_mask, device)
    t = input_ids.shape[1]
    x = params["shared"][input_ids].to(compute_dtype)
    pos = torch.arange(t)
    bias = _position_bias(params["encoder"]["rel_bias"], pos, pos, True, config)
    mask = attention_mask.to(torch.bool)[:, None, None, :]
    for layer in params["encoder"]["layers"]:
        h = _t5_norm(x, layer["ln0"], config.layer_norm_epsilon)
        x = x + _attention(h, h, layer["attn"], config, bias, mask)
        h = _t5_norm(x, layer["ln1"], config.layer_norm_epsilon)
        x = x + _ff(h, layer["ff"], config)
    return _t5_norm(x, params["encoder"]["final_ln"], config.layer_norm_epsilon)


def _decoder_hidden(params: Params, decoder_ids: torch.Tensor, enc_hidden: torch.Tensor,
                    enc_valid: torch.Tensor, config: T5Config, compute_dtype,
                    self_bias: torch.Tensor, causal: torch.Tensor) -> torch.Tensor:
    """The decoder's final normed hidden states [B, T_dec, D]; ``self_bias``
    [1, H, T_dec, T_dec] and ``causal`` [1, 1, T_dec, T_dec] are the
    caller's (a prefix of a longer buffer's is the same)."""
    x = params["shared"][decoder_ids].to(compute_dtype)
    for layer in params["decoder"]["layers"]:
        h = _t5_norm(x, layer["ln0"], config.layer_norm_epsilon)
        x = x + _attention(h, h, layer["self_attn"], config, self_bias, causal)
        h = _t5_norm(x, layer["ln1"], config.layer_norm_epsilon)
        x = x + _attention(h, enc_hidden, layer["cross_attn"], config, None, enc_valid)
        h = _t5_norm(x, layer["ln2"], config.layer_norm_epsilon)
        x = x + _ff(h, layer["ff"], config)
    return _t5_norm(x, params["decoder"]["final_ln"], config.layer_norm_epsilon)


def _logits(params: Params, x: torch.Tensor, config: T5Config) -> torch.Tensor:
    """Float32 logits [..., V] of final hidden states ``x``. Tied: ``x *
    d_model**-0.5`` in the compute dtype (the factor rounded to it, as the
    reference's weakly typed constant is), then a float32 product with
    ``shared``. Untied: the compute-dtype product, then float32."""
    if config.tie_word_embeddings:
        x = x * torch.tensor(config.d_model ** -0.5, dtype=x.dtype, device=x.device)
        return torch.matmul(x.to(torch.float32), params["shared"].to(torch.float32).T)
    return _dense(x, params["lm_head"]).to(torch.float32)


def _decoder_masks(params: Params, t: int, config: T5Config):
    device = _params_device(params)
    pos = torch.arange(t)
    self_bias = _position_bias(params["decoder"]["rel_bias"], pos, pos, False, config)
    causal = torch.tril(torch.ones((t, t), dtype=torch.bool, device=device))[None, None]
    return self_bias, causal


def t5_decode_step(params: Params, decoder_ids, enc_hidden: torch.Tensor, enc_mask,
                   config: T5Config, compute_dtype=torch.float32) -> torch.Tensor:
    """Full (non-incremental) decoder forward over ``decoder_ids``; returns
    float32 logits [B, T_dec, V]."""
    device = _params_device(params)
    decoder_ids, enc_mask = _ids(decoder_ids, device), _ids(enc_mask, device)
    self_bias, causal = _decoder_masks(params, decoder_ids.shape[1], config)
    enc_valid = enc_mask.to(torch.bool)[:, None, None, :]
    x = _decoder_hidden(params, decoder_ids, enc_hidden, enc_valid, config, compute_dtype,
                        self_bias, causal)
    return _logits(params, x, config)


def t5_greedy_decode(params: Params, input_ids, attention_mask, config: T5Config,
                     max_new_tokens: int, compute_dtype=torch.float32,
                     eos_token_id: Optional[int] = None, return_logits: bool = True
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Greedy seq2seq decode. Returns (gen ids [B, max_new] int32, logits
    [B, max_new, V] float32, or None with ``return_logits=False``). Every
    step runs, as in the reference: a finished row emits ``eos_token_id``
    and its logits are still returned. Step t runs the decoder over the
    first t + 1 positions and the lm_head over the last."""
    device = _params_device(params)
    input_ids, attention_mask = _ids(input_ids, device), _ids(attention_mask, device)
    b = input_ids.shape[0]
    with torch.inference_mode():
        enc_hidden = t5_encode(params, input_ids, attention_mask, config, compute_dtype)
        enc_valid = attention_mask.to(torch.bool)[:, None, None, :]
        self_bias, causal = _decoder_masks(params, max_new_tokens, config)
        dec = torch.full((b, max_new_tokens + 1), config.decoder_start_token_id,
                         dtype=torch.long, device=device)
        done = torch.zeros((b,), dtype=torch.bool, device=device)
        tokens, logits = [], []
        for t in range(max_new_tokens):
            n = t + 1
            x = _decoder_hidden(params, dec[:, :n], enc_hidden, enc_valid, config,
                                compute_dtype, self_bias[:, :, :n, :n], causal[:, :, :n, :n])
            step_logits = _logits(params, x[:, t], config)
            token = torch.argmax(step_logits, dim=-1)
            if eos_token_id is not None:
                token = torch.where(done, torch.full_like(token, eos_token_id), token)
                done = done | (token == eos_token_id)
            dec[:, n] = token
            tokens.append(token)
            if return_logits:
                logits.append(step_logits)
        gen_ids = torch.stack(tokens, dim=1).to(torch.int32)
        return gen_ids, (torch.stack(logits, dim=1) if return_logits else None)


# -----------------------------------------------------------------------------
# HF conversion + Backend
# -----------------------------------------------------------------------------


def convert_hf_t5_state_dict(state_dict: Dict[str, Any], config: T5Config) -> Params:
    """Map an HF T5 state_dict (numpy arrays or tensors) to the reference's
    parameter layout, on the tensors' own device and in their own dtypes:
    ``[out, in]`` weights become contiguous ``[in, out]`` kernels."""
    def tensor(name):
        v = state_dict[name]
        return v if torch.is_tensor(v) else torch.from_numpy(np.array(v))

    def w(name):
        return tensor(name).T.contiguous()  # torch [out,in] -> [in,out]

    def block(prefix, decoder: bool):
        layers = []
        n = config.num_decoder_layers if decoder else config.num_layers
        for i in range(n):
            p = f"{prefix}.block.{i}.layer"
            attn = {
                "q": w(f"{p}.0.SelfAttention.q.weight"),
                "k": w(f"{p}.0.SelfAttention.k.weight"),
                "v": w(f"{p}.0.SelfAttention.v.weight"),
                "o": w(f"{p}.0.SelfAttention.o.weight"),
            }
            layer = {"ln0": tensor(f"{p}.0.layer_norm.weight")}
            if decoder:
                layer["self_attn"] = attn
                layer["cross_attn"] = {
                    "q": w(f"{p}.1.EncDecAttention.q.weight"),
                    "k": w(f"{p}.1.EncDecAttention.k.weight"),
                    "v": w(f"{p}.1.EncDecAttention.v.weight"),
                    "o": w(f"{p}.1.EncDecAttention.o.weight"),
                }
                layer["ln1"] = tensor(f"{p}.1.layer_norm.weight")
                ff_idx, layer["ln2"] = 2, tensor(f"{p}.2.layer_norm.weight")
            else:
                layer["attn"] = attn
                ff_idx, layer["ln1"] = 1, tensor(f"{p}.1.layer_norm.weight")
            ffp = f"{p}.{ff_idx}.DenseReluDense"
            if config.is_gated:
                layer["ff"] = {"wi_0": w(f"{ffp}.wi_0.weight"),
                               "wi_1": w(f"{ffp}.wi_1.weight"),
                               "wo": w(f"{ffp}.wo.weight")}
            else:
                layer["ff"] = {"wi": w(f"{ffp}.wi.weight"), "wo": w(f"{ffp}.wo.weight")}
            layers.append(layer)
        return {
            "layers": layers,
            "rel_bias": tensor(f"{prefix}.block.0.layer.0.SelfAttention"
                               ".relative_attention_bias.weight"),
            "final_ln": tensor(f"{prefix}.final_layer_norm.weight"),
        }

    params: Params = {
        "shared": tensor("shared.weight"),
        "encoder": block("encoder", decoder=False),
        "decoder": block("decoder", decoder=True),
    }
    if not config.tie_word_embeddings and "lm_head.weight" in state_dict:
        params["lm_head"] = w("lm_head.weight")
    return params


def _map_tree(fn, node):
    if isinstance(node, dict):
        return {k: _map_tree(fn, v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_map_tree(fn, v) for v in node]
    return fn(node)


def cast_t5_params(params: Params, compute_dtype) -> Params:
    """Floating parameters of 2 or more dims (kernels, embeddings, the
    relative-position biases) to ``compute_dtype``; the 1-d norms as they
    are (float32 from a checkpoint)."""
    return _map_tree(lambda x: x.to(compute_dtype)
                     if x.is_floating_point() and x.dim() >= 2 else x, params)


def t5_params_from_jax(tree, device=None) -> Params:
    """The JAX package's T5 parameter pytree (leaves as numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as tensors on ``device`` (default:
    the GPU), in the same structure and dtypes."""
    from kirag_tpu_torch.models.llm import _tensor_from_numpy

    device = _entry_device(device)
    return _map_tree(lambda a: _tensor_from_numpy(a, device), tree)


def load_t5(model_name_or_path: str, compute_dtype=torch.bfloat16, device=None
            ) -> Tuple[Params, T5Config]:
    """Load a T5 checkpoint from a local HF directory (``config.json`` +
    ``model.safetensors`` or ``pytorch_model.bin``) onto ``device`` (default:
    the GPU), floating parameters of 2 or more dims in ``compute_dtype``."""
    from kirag_tpu_torch.models.encoders import read_safetensors

    if not os.path.isdir(model_name_or_path):
        raise FileNotFoundError(
            f"{model_name_or_path} is not a local directory; pass the path of a downloaded "
            "checkpoint")
    device = _entry_device(device)
    with open(os.path.join(model_name_or_path, "config.json")) as f:
        config = config_from_hf(json.load(f))
    st = os.path.join(model_name_or_path, "model.safetensors")
    bin_path = os.path.join(model_name_or_path, "pytorch_model.bin")
    if os.path.exists(st):
        state_dict = read_safetensors(st)
    elif os.path.exists(bin_path):
        state_dict = {k: v.to(torch.float32) for k, v in torch.load(
            bin_path, map_location="cpu", weights_only=True).items()}
    else:
        raise FileNotFoundError(f"no model.safetensors or pytorch_model.bin under "
                                f"{model_name_or_path}")
    params = cast_t5_params(convert_hf_t5_state_dict(state_dict, config), compute_dtype)
    del state_dict
    return _map_tree(lambda x: x.to(device), params), config


class TorchT5Backend:
    """Encoder-decoder Backend for :class:`kirag_tpu_torch.generation.Generator`.

    The reference tokenizes encoder-decoder prompts as plain text (right
    padding; `generator/generator.py:272-279`), so Generators using this
    backend should be constructed with ``is_chat=False``. Prompts are
    right-padded to a bucket, and a prompt longer than the largest bucket
    keeps its head. numpy in, numpy out; the parameters must lie on
    ``device`` (default: the GPU)."""

    is_encoder_decoder = True

    def __init__(self, params: Params, config: T5Config, eos_token_id: int,
                 compute_dtype=torch.bfloat16, prompt_buckets=(64, 128, 256, 512, 1024),
                 device=None):
        self.device = _entry_device(device)
        held = _params_device(params)
        if held.type != self.device.type or (
                self.device.index is not None and held.index != self.device.index):
            raise ValueError(f"the parameters lie on {held}, not on {self.device}")
        self.params = params
        self.config = config
        self.eos_token_id = eos_token_id
        self.compute_dtype = compute_dtype
        self.prompt_buckets = prompt_buckets

    def greedy(self, input_ids: np.ndarray, attention_mask: np.ndarray,
               max_new_tokens: int, return_logits: bool = True
               ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        t = input_ids.shape[1]
        bucket = next((b for b in self.prompt_buckets if b >= t), self.prompt_buckets[-1])
        if bucket > t:  # encoder input: extend RIGHT padding (mask handles it)
            input_ids = np.pad(input_ids, ((0, 0), (0, bucket - t)))
            attention_mask = np.pad(attention_mask, ((0, 0), (0, bucket - t)))
        elif bucket < t:
            input_ids = input_ids[:, :bucket]
            attention_mask = attention_mask[:, :bucket]
        ids, logits = t5_greedy_decode(
            self.params, input_ids, attention_mask, self.config, max_new_tokens,
            self.compute_dtype, eos_token_id=self.eos_token_id, return_logits=return_logits)
        return (ids.cpu().numpy().astype(np.int32),
                logits.cpu().numpy() if return_logits else None)
