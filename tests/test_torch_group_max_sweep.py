"""A model of how the float K5 (``csrc/group_max.cu``'s
``group_max_sweep_kernel``) peels each group in registers, held bitwise
against ``group_max_plain``.

After a pass of ``score_passes`` lane l of a warp holds the scores of lanes
l + 32 i (i < 4) of its group for one query. Up to 24 winners the kernel runs
the reference's rounds there (each lane's best order key by a strict ``>``
in register order, the warp's largest key and the lowest lane holding it by
two ``redux.sync``, the winner's key masked to -inf's by its owner, the value
read back from the winner's register); above, one bitonic sort of the 128
(score, lane) pairs held at places 4 l + i, whose -inf places report lane 0.
Both are restated here step by step over all groups at once and held, at
every W, against the plain version's W rounds of a masked maximum on
tie-heavy integer scores with groups of fewer than W finite scores. The
kernel itself runs only on the card (``tests/test_torch_kernels.py``).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from kirag_tpu_torch.kernels import group_max_plain
from kirag_tpu_torch.kernels.exact import LANES, quant_scores

WARP = 32
REGS = LANES // WARP  # scores a lane holds
INF = float("-inf")
WINNERS = (1, 2, 8, 24, 25, 33, 128)


def beats(v, i, bv, bi):
    """The peel's strict order: larger value first, then the lower lane."""
    return (v > bv) | ((v == bv) & (i < bi))


def order_key(x: torch.Tensor) -> torch.Tensor:
    """``order_key``: f32 scores as unsigned keys (int64 here) in the
    peel's value order, -0 as +0."""
    u = (x + 0.0).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 2 ** 31, ~u & 0xFFFFFFFF, u | 2 ** 31)


def model_rounds(scores: torch.Tensor, w: int):
    """``peel_rounds`` over scores [..., 128]: returns (values, lanes)
    [..., W] as the kernel writes them."""
    key = order_key(scores).reshape(*scores.shape[:-1], REGS, WARP).transpose(-1, -2).clone()
    masked = int(order_key(torch.tensor(INF)))
    lane = torch.arange(WARP)
    vals, lanes = [], []
    for _ in range(w):
        bk, bi = key[..., 0].clone(), lane.expand(key.shape[:-1]).clone()  # [.., lane]
        for i in range(1, REGS):  # ascending lanes: strict > keeps the lowest
            take = key[..., i] > bk
            bk, bi = torch.where(take, key[..., i], bk), torch.where(take, lane + WARP * i, bi)
        top = bk.amax(-1)                                                # redux.sync max
        win = torch.where(bk == top[..., None], bi, LANES).amin(-1)     # redux.sync min
        value = torch.gather(scores, -1, win[..., None])[..., 0]        # its row's register
        vals.append(torch.where(top == masked, INF, value))
        lanes.append(win)
        owner = (win[..., None] & (WARP - 1)) == lane
        for i in range(REGS):
            key[..., i] = torch.where(owner & (win[..., None] // WARP == i), masked, key[..., i])
    return torch.stack(vals, -1), torch.stack(lanes, -1)


def model_sort(scores: torch.Tensor, w: int):
    """``sort_winners`` over scores [..., 128]: register i of lane l is
    place 4 l + i and starts with row l + 32 i; the stages k = 2 .. 128 and
    distances jj = k/2 .. 1 of a bitonic network, ``order_pair`` inside a
    thread (jj = 2, 1), a shuffle with lane ^ (jj / 4) above; then the -inf
    places report lane 0."""
    place = torch.arange(LANES)
    row = (place // REGS) + WARP * (place % REGS)        # place 4 l + i holds row l + 32 i
    v, idx = scores[..., row].clone(), row.expand(scores.shape).clone()
    e = place
    k = 2
    while k <= LANES:
        jj = k // 2
        while jj > 0:
            if jj < REGS:  # order_pair<A, B>: swap unless the pair is in the stage's order
                lo = e[(e & jj) == 0]
                hi = lo ^ jj
                swap = beats(v[..., hi], idx[..., hi], v[..., lo], idx[..., lo]) == \
                    ((lo & k) == 0)
                v_lo, i_lo = v[..., lo].clone(), idx[..., lo].clone()
                v[..., lo] = torch.where(swap, v[..., hi], v_lo)
                idx[..., lo] = torch.where(swap, idx[..., hi], i_lo)
                v[..., hi] = torch.where(swap, v_lo, v[..., hi])
                idx[..., hi] = torch.where(swap, i_lo, idx[..., hi])
            else:
                ov, oi = v[..., e ^ jj], idx[..., e ^ jj]
                keep_better = ((e & jj) == 0) == ((e & k) == 0)
                take = beats(ov, oi, v, idx) == keep_better
                v, idx = torch.where(take, ov, v), torch.where(take, oi, idx)
            jj //= 2
        k *= 2
    return v[..., :w], torch.where(v == INF, 0, idx)[..., :w]


def corpus_of(values: np.ndarray) -> torch.Tensor:
    """Rows [s, 0] that score s against the query [1, 1], and rows of -3e38
    for -inf scores (their sum overflows)."""
    rows = np.zeros((len(values), 2), np.float32)
    finite = np.isfinite(values)
    rows[finite, 0] = values[finite]
    rows[~finite] = -3e38
    return torch.from_numpy(rows)


def check_models(values: np.ndarray, n_q: int, w: int) -> None:
    c = corpus_of(values)
    q = torch.tensor([[float(j + 1)] * 2 for j in range(n_q)])  # positive: no +inf, no NaN
    want = group_max_plain(q, c, w)                                   # [Q, W, G]
    scores = quant_scores(q, c, None, "none").view(n_q, -1, LANES)    # [Q, G, 128]
    for model in (model_rounds, model_sort):
        vals, lanes = model(scores, w)                                # [Q, G, W]
        assert torch.equal(vals.transpose(1, 2), want[0]), model.__name__
        assert torch.equal(lanes.transpose(1, 2).to(torch.int32), want[1]), model.__name__


def group_values(rng, groups: int, span: int, n_inf) -> np.ndarray:
    """Integer scores in [-span, span] (ties everywhere), with n_inf[g] of
    group g's rows at random lanes scoring -inf."""
    values = rng.integers(-span, span + 1, (groups, LANES)).astype(np.float32)
    for g, n in enumerate(n_inf):
        values[g, rng.permutation(LANES)[:n]] = -np.inf
    return values.reshape(-1)


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(w=st.sampled_from(WINNERS), n_q=st.integers(1, 2), span=st.integers(0, 6),
       n_inf=st.lists(st.sampled_from([0, 0, 1, 5, 64, 100, 127, 128]), min_size=1,
                      max_size=3),
       seed=st.integers(0, 2 ** 32 - 1))
def test_rounds_and_sort_equal_the_plain_peel(w, n_q, span, n_inf, seed):
    """Tie-heavy integer groups, some with fewer finite scores than W: the
    kernel's rounds and its sort give the plain version's values and lanes."""
    rng = np.random.default_rng(seed)
    check_models(group_values(rng, len(n_inf), span, n_inf), n_q, w)


@pytest.mark.parametrize("w", WINNERS)
def test_models_on_the_tails(w):
    """Groups with no, one, W - 1, W and every score finite, all scores tied:
    once only -inf is left, every round reports lane 0."""
    rng = np.random.default_rng(w)
    n_inf = sorted({LANES, LANES - 1, LANES - w + 1, LANES - w, 0} & set(range(LANES + 1)))
    check_models(group_values(rng, len(n_inf), 0, n_inf), 2, w)
    check_models(group_values(rng, len(n_inf), 3, n_inf), 1, w)


def test_models_on_signed_zeros():
    """-0 and +0 tie (the reference compares values): both models give the
    lower lane, as the reference's peel does on the same scores."""
    scores = torch.zeros(1, 1, LANES)
    scores[0, 0, 1::3] = -0.0
    scores[0, 0, 70] = 1.0
    scores[0, 0, 100:] = INF
    want_vals, want_lanes = [], []
    s = scores.clone()
    for _ in range(LANES):  # the reference's rounds on the scores themselves
        m = s.amax(-1, keepdim=True)
        lane = torch.where(s == m, torch.arange(LANES), LANES).amin(-1, keepdim=True)
        want_vals.append(m)
        want_lanes.append(lane)
        s = s.scatter(-1, lane, INF)
    want_vals, want_lanes = torch.cat(want_vals, -1), torch.cat(want_lanes, -1)
    for model in (model_rounds, model_sort):
        vals, lanes = model(scores, LANES)
        assert torch.equal(vals, want_vals) and torch.equal(lanes, want_lanes), model.__name__


def test_models_on_random_scores():
    """Distinct random scores: the sort is the descending order itself."""
    rng = np.random.default_rng(5)
    values = rng.standard_normal(4 * LANES).astype(np.float32)
    check_models(values, 2, 128)
    s = torch.from_numpy(values).view(1, -1, LANES)
    vals, lanes = model_sort(s, 128)
    order = torch.sort(s, dim=-1, descending=True)
    assert torch.equal(vals, order.values) and torch.equal(lanes, order.indices)
