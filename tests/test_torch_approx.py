"""The port's approximate search held against the JAX package's K5.

``kirag_tpu_torch.ops.approx`` (``grouped_max_scores``, ``approx_topk_mips``;
the kernel's plain version on the CPU) against
``kirag_tpu.ops.pallas_mips`` run in interpret mode, for float32, bfloat16,
int8 and packed-int4 corpora, on the same numpy inputs. Integer data (small
integer rows and queries; int8/int4 codes with power-of-two scales) makes
every score exact in any summation order, with ties at every selection, so
values, lanes and ids must be equal. Interpret-mode calls stay at or below
2048 x 256 with chunks of 256 or 512.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kirag_tpu.ops.pallas_mips import approx_topk_mips as jax_approx
from kirag_tpu.ops.pallas_mips import grouped_max_scores as jax_grouped
from kirag_tpu_torch.ops.approx import approx_topk_mips, grouped_max_scores
from kirag_tpu_torch.ops.exact import exact_topk_mips

FORMATS = ["float32", "bfloat16", "int8", "int4"]


def integer_case(rng, fmt, n, d, n_q=4):
    """(queries, corpus, scales) as numpy arrays of one format."""
    q = rng.randint(-2, 3, (n_q, d)).astype(np.float32)
    if fmt == "int8":
        return q, rng.randint(-3, 4, (n, d)).astype(np.int8), \
            np.exp2(rng.randint(-3, 0, n)).astype(np.float32)
    if fmt == "int4":
        return q, rng.randint(0, 256, (n, d // 2)).astype(np.uint8), \
            np.exp2(rng.randint(-3, 0, (n, d // 128))).astype(np.float32)
    return q, rng.randint(-3, 4, (n, d)).astype(np.float32), None


def both(fmt, q, c, s):
    """The same inputs as JAX arrays and as torch tensors (bfloat16 for a
    bfloat16 corpus, whose queries are rounded to it as the indexer does)."""
    jq, jc = jnp.asarray(q), jnp.asarray(c)
    tq, tc = torch.from_numpy(q), torch.from_numpy(c)
    if fmt == "bfloat16":
        jq, jc = jq.astype(jnp.bfloat16), jc.astype(jnp.bfloat16)
        tq, tc = tq.to(torch.bfloat16), tc.to(torch.bfloat16)
    js = None if s is None else jnp.asarray(s)
    ts = None if s is None else torch.from_numpy(s)
    return (jq, jc, js), (tq, tc, ts)


@pytest.mark.parametrize("winners", [1, 2, 128])
@pytest.mark.parametrize("fmt", FORMATS)
def test_integer_data_equal_to_jax(rng, fmt, winners):
    """Group maxima and lanes, then the top-k with a partly filled last
    group, bitwise the reference's."""
    n = 1024 if winners == 128 else 2048
    q, c, s = integer_case(rng, fmt, n, 256)
    (jq, jc, js), (tq, tc, ts) = both(fmt, q, c, s)
    chunk = 256 if winners == 128 else 512
    jgmax, jgidx = jax_grouped(jq, jc, chunk_size=chunk, interpret=True, scales=js,
                               winners=winners)
    gmax, gidx = grouped_max_scores(tq, tc, winners, ts)
    assert gmax.shape == (4, winners, n // 128) and gidx.dtype == torch.int32
    np.testing.assert_array_equal(gmax.numpy(), np.asarray(jgmax))
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(jgidx))
    valid = n - 100
    jv, ji = jax_approx(jq, jc, 50, chunk_size=chunk, valid_rows=valid, interpret=True,
                        scales=js, winners_per_group=winners)
    vals, idx = approx_topk_mips(tq, tc, 50, valid_rows=valid, scales=ts,
                                 winners_per_group=winners)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    assert int(idx.max()) < valid


def test_random_rows_match_jax(rng):
    """Unit rows: values within 1e-5 (f32 sums of 256 products in two
    orders), ids equal (no two candidates lie that close here)."""
    c = rng.randn(2048, 256).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    q = c[[5, 700, 1500]] + 0.1 * rng.randn(3, 256).astype(np.float32)
    jv, ji = jax_approx(jnp.asarray(q), jnp.asarray(c), 20, chunk_size=512, interpret=True,
                        winners_per_group=2)
    vals, idx = approx_topk_mips(torch.from_numpy(q), torch.from_numpy(c), 20,
                                 winners_per_group=2)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jv), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    assert idx[:, 0].tolist() == [5, 700, 1500]


def test_pad_rows_take_winner_slots_before_the_mask():
    """The reference's order, copied on purpose: the peel runs over the raw
    scores of the zero pad rows and only then masks rows past valid_rows.
    Every real row scores below 0, so in the partly filled last group a pad
    row (score 0) wins the one slot and is masked: that group's real rows
    never appear, in either package."""
    c = -np.ones((200, 16), dtype=np.float32)
    c[:, 0] = -np.arange(1, 201, dtype=np.float32) / 200
    q = np.ones((2, 16), dtype=np.float32)
    jv, ji = jax_approx(jnp.asarray(q), jnp.asarray(c), 4, chunk_size=256, interpret=True)
    vals, idx = approx_topk_mips(torch.from_numpy(q), torch.from_numpy(c), 4)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    assert idx[0].tolist() == [0, 0, 0, 0] and np.isfinite(vals[0, 0].item())
    assert vals[0, 1:].tolist() == [-np.inf] * 3  # rows 128-199 lost their group's slot
    # a full last group of real rows offers its best one
    full = -np.ones((256, 16), dtype=np.float32)
    full[:, 0] = -np.arange(1, 257, dtype=np.float32) / 256
    vals, idx = approx_topk_mips(torch.from_numpy(q), torch.from_numpy(full), 4)
    assert idx[0, :2].tolist() == [0, 128] and vals[0, 2:].tolist() == [-np.inf] * 2


@pytest.mark.parametrize("fmt", ["float32", "int8"])
def test_k_beyond_the_candidates_pads_like_jax(rng, fmt):
    """k = 40 over 3 groups x 2 winners: 6 candidates, the rest -inf and row 0."""
    q, c, s = integer_case(rng, fmt, 300, 256, n_q=3)
    (jq, jc, js), (tq, tc, ts) = both(fmt, q, c, s)
    jv, ji = jax_approx(jq, jc, 40, chunk_size=256, interpret=True, scales=js,
                        winners_per_group=2)
    vals, idx = approx_topk_mips(tq, tc, 40, scales=ts, winners_per_group=2)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    assert vals.shape == (3, 40) and np.isfinite(vals[:, :6].numpy()).all()
    assert (vals[:, 6:] == -np.inf).all() and (idx[:, 6:] == 0).all()


@pytest.mark.parametrize("fmt", FORMATS)
def test_all_winners_is_exact_search(rng, fmt):
    """W = 128 surfaces every row: the exact search's values and ids, ties
    to the lower row in both."""
    q, c, s = integer_case(rng, fmt, 3000, 256)
    _, (tq, tc, ts) = both(fmt, q, c, s)
    vals, idx = approx_topk_mips(tq, tc, 60, valid_rows=2950, scales=ts,
                                 winners_per_group=128)
    want = exact_topk_mips(tq, tc, 60, chunk_size=1024, valid_rows=2950, scales=ts,
                           select="capdom", impl="stream")
    assert torch.equal(vals, want[0]) and torch.equal(idx, want[1])


def test_row_offset_shifts_the_ids(rng):
    q, c, _ = integer_case(rng, "float32", 512, 64)
    tq, tc = torch.from_numpy(q), torch.from_numpy(c)
    vals, idx = approx_topk_mips(tq, tc, 4)  # 4 groups, 4 finite candidates
    vals_o, idx_o = approx_topk_mips(tq, tc, 4, row_offset=10_000)
    assert torch.equal(vals, vals_o) and torch.equal(idx_o, idx + 10_000)


def test_indexer_approx_reads_only_the_groups_with_rows(rng):
    """A corpus padded to the chunk grid (512 rows for 300 at chunk 256) is
    searched through a view of its first 3 groups: no copy, and the same
    answer as over the whole padded corpus, whose pad groups give only -inf
    candidates at row 0 (k = 12 exceeds the 6 candidates of the view)."""
    from kirag_tpu_torch.index import TorchIndexer

    q, c, _ = integer_case(rng, "float32", 300, 64, n_q=3)
    index = TorchIndexer(64, device="cpu", exact_impl="kernel", pallas_chunk_size=256,
                         approx_winners=2)
    index.index_data(list(range(300)), c)
    index.to_device()
    corpus, scales = index._group_view()
    assert corpus.shape == (384, 64) and scales is None and index._device_corpus.shape[0] == 512
    assert corpus.data_ptr() == index._device_corpus.data_ptr()
    want = approx_topk_mips(torch.from_numpy(q), index._device_corpus, 12, valid_rows=300,
                            winners_per_group=2)
    got = index._run_mips(torch.from_numpy(q), 12, mode="approx")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (got[0][:, 6:] == -np.inf).all() and (got[1][:, 6:] == 0).all()
