"""Greedy speculative decoding, draft-and-verify (port of
:mod:`kirag_tpu.models.speculative`).

A small DRAFT model proposes ``gamma - 1`` tokens one step at a time; the
TARGET verifies them in ONE ``gamma``-token forward. A draft token is kept
iff it equals the target's argmax at its position, so the emitted stream is
the target's own greedy stream (:func:`kirag_tpu_torch.models.llm.greedy_decode`),
token for token. A round emits ``n_accepted + 1`` tokens for one read of the
target's weights. With 4-bit weights and ``int4_impl="kernel"`` the verify
forward's projections run through K6 while ``B * gamma <= 32``.

Mechanics per round (every row of the batch stepped together):

1. The draft feeds ``[p0, d1..d_{g-1}]`` from its own KV cache (g
   single-token steps) and proposes ``d1..d_{g-1}``; the g-th proposal is
   dropped, and the last feed leaves d_{g-1}'s K/V in the draft cache.
2. The target runs one g-token forward over the same window; ``T_i`` is its
   argmax after fed position i.
3. ``n_acc`` is the length of the all-true prefix of ``d_i == T_i``; the
   round emits ``d1..d_{n_acc}`` and the correction ``T[n_acc]``.
4. Both models wrote K/V for all g slots; the rejected tail's cache mask is
   zeroed and ``write_at`` advances by ``n_acc + 1`` per row.

The reference's ``lax.scan`` and ``while_loop`` become Python loops; the
loop's condition reads one flag from the device a round. Caches are updated
in place, so a state handed to :func:`speculative_resume` is consumed by it.
Per-row writes go through explicit index tensors. PyTorch refuses an index
out of range where JAX drops the write, so each index is kept in range:

- a row that may still emit has ``write_at + gamma <= t_prompt + budget +
  gamma``, the reserved cache. A finished row (eos, or past the budget after
  a long round) is still fed with the batch, and its slots may pass the end:
  they are clamped to its last slot, which no emitted token reads again
  (JAX drops those writes);
- stream indices stay within the output buffer, whose last column takes the
  rejected positions' writes; a resume whose budget passes the buffer is
  refused.

EOS follows greedy's pad-after-finish contract. Logits
(``return_logits=True``) are the distributions that chose each token up to
and including a row's first eos.
"""

from __future__ import annotations

from typing import Optional

import torch

from kirag_tpu_torch.models.llm import (
    LlamaConfig,
    Params,
    _params_device,
    _prefill_state,
    _to_device,
    llama_block_forward,
)

_SUB_KEYS = ("k", "v", "cache_mask", "cache_pos", "write_at")


def check_full_precision_cache(t_config: LlamaConfig, d_config: LlamaConfig) -> None:
    """Refuse a quantized KV cache: the stream equals greedy's only while the
    target's logits over a fed window equal its logits over the cache, and
    an int8 cache rounds the cached slots but not the window's."""
    if t_config.kv_quant_bits or d_config.kv_quant_bits:
        raise ValueError("speculative decoding requires a full-precision KV cache "
                         "(kv_quant_bits=None)")


def _per_row_state(state, bsz):
    """A :func:`_prefill_state` dict's cache part with a per-row ``write_at``
    (rows diverge under speculative acceptance)."""
    state = {k: state[k] for k in _SUB_KEYS}
    state["write_at"] = torch.full((bsz,), state["write_at"], dtype=torch.long,
                                   device=state["cache_mask"].device)
    return state


def _init_spec_state(t_params, t_config, d_params, d_config, input_ids, attention_mask,
                     budget, gamma, compute_dtype, eos_token_id):
    """Prefill both models with ``budget + gamma`` slots reserved and build
    the round loop's state. Returns ``(first_token, first_logits, state)``;
    the output buffer is ``budget + gamma + 1`` wide, its last column the
    trash column of the bounded scatter."""
    check_full_precision_cache(t_config, d_config)
    bsz = input_ids.shape[0]
    reserve = budget + gamma
    first, first_lg, t_state = _prefill_state(t_params, input_ids, attention_mask, t_config,
                                              reserve, compute_dtype, eos_token_id)
    _, _, d_state = _prefill_state(d_params, input_ids, attention_mask, d_config, reserve,
                                   compute_dtype, eos_token_id)
    device = input_ids.device
    out_ids = torch.zeros(bsz, budget + gamma + 1, dtype=torch.long, device=device)
    out_ids[:, 0] = first
    st = {
        "t": _per_row_state(t_state, bsz),
        "d": _per_row_state(d_state, bsz),
        "pending": t_state["pending"],
        "pos": t_state["pos"],
        "done": t_state["done"],
        "n_out": torch.ones(bsz, dtype=torch.long, device=device),
        "out_ids": out_ids,
        "out_lg": None,
        # acc_hist[a]: (active row, round) pairs that accepted exactly a drafts
        "acc_hist": torch.zeros(gamma, dtype=torch.long, device=device),
    }
    return first, first_lg, st


def _write_slots(sub, nk, nv, rows, slots, positions):
    """Write new K/V ([B, t, nkv, hd]) and positions at per-row cache slots
    (``rows`` and ``slots`` broadcast to [B, t]), in place."""
    for cache, new in zip(sub["k"] + sub["v"], nk + nv):
        cache[rows, slots] = new.to(cache.dtype)
    sub["cache_pos"][rows, slots] = positions


def _in_cache(sub, slots):
    """Cache slots clamped to the last one (only a finished row's pass it)."""
    return torch.clamp(slots, max=sub["cache_mask"].shape[1] - 1)


def _chain_step(params, config, sub, token, pos1, compute_dtype):
    """One single-token draft step, its K/V written at each row's
    ``write_at`` and unmasked at once, so the next step attends it."""
    lg, nk, nv = llama_block_forward(
        params, token[:, None], pos1[:, None], config, sub["k"], sub["v"], sub["cache_mask"],
        compute_dtype=compute_dtype, cache_positions=sub["cache_pos"])
    rows = torch.arange(token.shape[0], device=token.device)
    w = sub["write_at"]
    slots = _in_cache(sub, w)
    _write_slots(sub, [k[:, 0] for k in nk], [v[:, 0] for v in nv], rows, slots, pos1)
    sub["cache_mask"][rows, slots] = 1
    sub["write_at"] = w + 1
    return lg[:, -1]


def _rollback(sub, w0, keep, gamma):
    """Set the cache mask of slots ``w0 .. w0 + gamma - 1`` to the kept
    prefix of length ``keep`` (the rejected tail to 0) and rewind
    ``write_at`` to ``w0 + keep``, per row."""
    steps = torch.arange(gamma, device=w0.device)
    rows = torch.arange(w0.shape[0], device=w0.device)[:, None]
    keep_mask = (steps[None, :] < keep[:, None]).to(sub["cache_mask"].dtype)
    sub["cache_mask"][rows, _in_cache(sub, w0[:, None] + steps[None, :])] = keep_mask
    sub["write_at"] = w0 + keep


def _spec_round(t_params, t_config, d_params, d_config, st, gamma, compute_dtype,
                eos_token_id, max_out, return_logits, draft_script=None):
    """One draft-propose / target-verify round: 1..gamma tokens a row.

    ``draft_script`` (optional, [B, W] integers) overrides the draft's
    proposal for stream slot ``s`` by ``draft_script[b, s]`` where that
    entry is >= 0 (negative: the draft's own argmax). The draft forward
    still runs and feeds the overridden token, so drafting costs the same;
    scripting the target's own stream with flips sets the acceptance rate on
    random weights."""
    device = st["pending"].device
    bsz = st["pending"].shape[0]
    rows = torch.arange(bsz, device=device)
    steps = torch.arange(gamma, device=device)
    p0, pos0 = st["pending"], st["pos"]
    active = (~st["done"]) & (st["n_out"] < max_out)
    n_out0 = st["n_out"]

    # 1. the draft chain: gamma feeds, gamma - 1 proposals used
    dsub = st["d"]
    dw0 = dsub["write_at"]
    fed, tok = [], p0
    for j in range(gamma):
        fed.append(tok)
        lg = _chain_step(d_params, d_config, dsub, tok, pos0 + j, compute_dtype)
        nxt = torch.argmax(lg, dim=-1)
        if draft_script is not None:
            # step j proposes d_{j+1}, the token of stream slot n_out + j
            idx = torch.clamp(n_out0 + j, 0, draft_script.shape[1] - 1)
            s = torch.gather(draft_script, 1, idx[:, None])[:, 0].to(nxt.dtype)
            nxt = torch.where(s >= 0, s, nxt)
        tok = nxt
    fed = torch.stack(fed, dim=1)                         # [B, gamma] = [p0, d1..]
    drafts = fed[:, 1:]                                   # [B, gamma - 1]

    # 2. the target's verify: one gamma-token forward
    tsub = st["t"]
    tw0 = tsub["write_at"]
    positions = pos0[:, None] + steps[None, :]
    lg_t, nk, nv = llama_block_forward(
        t_params, fed, positions, t_config, tsub["k"], tsub["v"], tsub["cache_mask"],
        compute_dtype=compute_dtype, cache_positions=tsub["cache_pos"])
    targets = torch.argmax(lg_t, dim=-1)                  # [B, gamma]
    _write_slots(tsub, nk, nv, rows[:, None], _in_cache(tsub, tw0[:, None] + steps[None, :]),
                 positions)

    # 3. acceptance: the all-true prefix of draft == target
    match = (drafts == targets[:, :gamma - 1]).long()
    n_acc = torch.cumprod(match, dim=1).sum(dim=1)
    keep = torch.where(active, n_acc + 1, torch.zeros_like(n_acc))
    # index_add: repeated indices add up (an indexed assignment would drop them)
    st["acc_hist"] = st["acc_hist"].index_add(0, n_acc, active.long())

    # round outputs: O_i = d_{i+1} for i < n_acc, O_{n_acc} = T[n_acc]
    gi = steps[None, :]
    y = torch.gather(targets, 1, n_acc[:, None])
    d_pad = torch.cat([drafts, torch.zeros_like(fed[:, :1])], dim=1)
    outs = torch.where(gi < n_acc[:, None], d_pad,
                       torch.where(gi == n_acc[:, None], y, torch.zeros_like(y)))
    if eos_token_id is not None:
        # pad-after-finish inside the round: positions after the first eos emit eos
        e = (outs == eos_token_id).long()
        outs = torch.where(torch.cumsum(e, dim=1) - e > 0,
                           torch.full_like(outs, eos_token_id), outs)

    # 4. roll back the rejected slots, advance the stream
    _rollback(tsub, tw0, keep, gamma)
    _rollback(dsub, dw0, keep, gamma)
    valid = gi < keep[:, None]
    trash = st["out_ids"].shape[1] - 1
    sidx = torch.where(valid, n_out0[:, None] + gi, torch.full_like(outs, trash))
    st["out_ids"][rows[:, None], sidx] = outs
    if return_logits:
        st["out_lg"][rows[:, None], sidx] = lg_t

    new_pending = torch.gather(outs, 1, n_acc[:, None])[:, 0]
    done = st["done"]
    if eos_token_id is not None:
        done_round = (valid & (outs == eos_token_id)).any(dim=1)
        new_pending = torch.where(done | done_round, torch.full_like(new_pending, eos_token_id),
                                  new_pending)
        done = done | done_round
    st.update(pending=torch.where(active, new_pending, p0), pos=pos0 + keep, done=done,
              n_out=n_out0 + keep)


def _run_rounds(t_params, t_config, d_params, d_config, st, gamma, compute_dtype,
                eos_token_id, cap, max_out, return_logits, draft_script):
    """Rounds while a row is neither done nor past ``cap`` (one host read of
    the condition a round)."""
    while bool(((~st["done"]) & (st["n_out"] < cap)).any()):
        _spec_round(t_params, t_config, d_params, d_config, st, gamma, compute_dtype,
                    eos_token_id, max_out, return_logits, draft_script=draft_script)


def _script_tensor(draft_script, device):
    if draft_script is None:
        return None
    return torch.as_tensor(draft_script, dtype=torch.long).to(device)


def speculative_decode(t_params: Params, t_config: LlamaConfig, d_params: Params,
                       d_config: LlamaConfig, input_ids, attention_mask, max_new_tokens: int,
                       gamma: int = 4, compute_dtype=torch.float32,
                       eos_token_id: Optional[int] = None, return_logits: bool = True,
                       draft_script=None, return_stats: bool = False):
    """:func:`~kirag_tpu_torch.models.llm.greedy_decode` with a draft model:
    the same (ids [B, G] int32, logits [B, G, V] f32 | None) and the same
    token stream. Prompts are LEFT-padded; both models share the vocab.
    ``gamma`` is the fed window a round (gamma - 1 proposals + the
    correction). ``draft_script``: see :func:`_spec_round`.
    ``return_stats`` also returns ``acc_hist`` ([gamma] int64: rounds that
    accepted exactly ``a`` drafts, summed over active rows)."""
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    device = _params_device(t_params)
    ids, mask = _to_device(input_ids, attention_mask, device)
    script = _script_tensor(draft_script, device)
    with torch.inference_mode():
        _, first_lg, st = _init_spec_state(t_params, t_config, d_params, d_config, ids, mask,
                                           max_new_tokens, gamma, compute_dtype, eos_token_id)
        if return_logits:
            bsz, width = st["out_ids"].shape
            st["out_lg"] = torch.zeros(bsz, width, t_config.vocab_size, dtype=torch.float32,
                                       device=device)
            st["out_lg"][:, 0] = first_lg
        _run_rounds(t_params, t_config, d_params, d_config, st, gamma, compute_dtype,
                    eos_token_id, max_new_tokens, max_new_tokens, return_logits, script)
        out = st["out_ids"][:, :max_new_tokens]
        if eos_token_id is not None:  # rows that finished early pad with eos
            col = torch.arange(max_new_tokens, device=device)[None, :]
            out = torch.where(col < st["n_out"][:, None], out, torch.full_like(out, eos_token_id))
        lg = st["out_lg"][:, :max_new_tokens] if return_logits else None
        out = out.to(torch.int32)
    if return_stats:
        return out, lg, st["acc_hist"]
    return out, lg


def speculative_start(t_params: Params, t_config: LlamaConfig, d_params: Params,
                      d_config: LlamaConfig, input_ids, attention_mask, total_new_tokens: int,
                      gamma: int = 4, compute_dtype=torch.float32,
                      eos_token_id: Optional[int] = None):
    """Speculative :func:`~kirag_tpu_torch.models.llm.prefill_decode`:
    prefill both models, emit the first token; returns (ids [B, 1] int32,
    resumable state). Rounds may overshoot a resume's steps: the surplus
    stays in the state's buffer for the next resume. No logits are carried
    (use :func:`speculative_decode` for them)."""
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    ids, mask = _to_device(input_ids, attention_mask, _params_device(t_params))
    with torch.inference_mode():
        first, _, st = _init_spec_state(t_params, t_config, d_params, d_config, ids, mask,
                                        total_new_tokens, gamma, compute_dtype, eos_token_id)
    st["served"] = 1
    return first[:, None].to(torch.int32), st


def speculative_resume(t_params: Params, t_config: LlamaConfig, d_params: Params,
                       d_config: LlamaConfig, state, n_steps: int, total_new_tokens: int,
                       gamma: int = 4, compute_dtype=torch.float32,
                       eos_token_id: Optional[int] = None, draft_script=None):
    """Serve the next ``n_steps`` tokens of every row's stream (the buffered
    surplus first, then fresh rounds); the state is updated in place and
    returned: (ids [B, n_steps] int32, state). ``draft_script`` as in
    :func:`speculative_decode`, its positions absolute: pass the same one to
    every resume of a sequence."""
    st = state
    bsz, width = st["out_ids"].shape
    if total_new_tokens > width - gamma - 1:
        raise ValueError(f"total_new_tokens={total_new_tokens} passes the budget of "
                         f"{width - gamma - 1} that speculative_start reserved")
    device = st["out_ids"].device
    script = _script_tensor(draft_script, device)
    served = st["served"]
    with torch.inference_mode():
        _run_rounds(t_params, t_config, d_params, d_config, st, gamma, compute_dtype,
                    eos_token_id, min(served + n_steps, total_new_tokens), total_new_tokens,
                    False, script)
        # a clamped gather: a caller past the budget gets pad tokens, not a
        # re-serve of old stream positions
        col = served + torch.arange(n_steps, device=device)[None, :]
        ids = torch.gather(st["out_ids"], 1, torch.clamp(col, 0, width - 1).expand(bsz, n_steps))
        pad = eos_token_id if eos_token_id is not None else 0
        ids = torch.where((col < st["n_out"][:, None]) & (col < width - 1), ids,
                          torch.full_like(ids, pad))
    st["served"] = served + n_steps
    return ids.to(torch.int32), st
