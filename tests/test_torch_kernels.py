"""The CUDA kernels' wrappers: device dispatch, launch counts, and (on a GPU)
each kernel against its plain version: K1 and K2 of the exact search (with
K4's int8, packed-int4 and 4-bit PQ scoring inside them), the exact-search
variants' K7a (scores and group maxima), K7b and K8 (group copies) and K9
(merge's window), K5 the approximate search's group top-W, K3 the encoder's
flash attention and its two backward kernels, K6 the LLM's 4-bit weight
matmul.

This file imports neither JAX nor ``kirag_tpu``, so the GPU machine, which
has neither, runs it alone:

    python -m pytest --noconftest tests/test_torch_kernels.py -q -m cuda

Tests marked ``cuda`` skip without a GPU. On integer-valued data every score
is exact in any summation order, so kernel and plain version agree bitwise.
"""

import dataclasses
import importlib.util
import math
from pathlib import Path

import pytest
import torch

from kirag_tpu_torch.kernels import (
    cap_assemble,
    cap_assemble_plain,
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_plain,
    flash_attention_plain,
    gather_groups,
    gather_groups_plain,
    group_max,
    group_max_plain,
    int4_matmul,
    int4_matmul_plain,
    launch_counts,
    reset_launch_counts,
    score_gather,
    score_gather_plain,
    score_gmax,
    score_gmax_plain,
    stream_capture,
    stream_capture_plain,
    window_merge,
    window_merge_plain,
)
from kirag_tpu_torch.kernels.attention import _forward
from kirag_tpu_torch.kernels.qmm import dequant_nibbles
from kirag_tpu_torch.ops.exact import _capture_budget, exact_topk_mips, hier_topk


def test_wrappers_reject_devices_without_kernels():
    q = torch.zeros(2, 8, device="meta")
    c = torch.zeros(256, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        stream_capture(q, c, 256, 128, 1)
    with pytest.raises(ValueError, match="no kernel"):
        gather_groups(q, c, torch.zeros(2, 1, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        group_max(q, c, 2)
    with pytest.raises(ValueError, match="no kernel"):
        score_gmax(q, c, 256, 128, "chunk")
    src = torch.zeros(2, 2, 256, device="meta")
    idx = torch.zeros(2, 3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        score_gather(src, idx)
    with pytest.raises(ValueError, match="no kernel"):
        cap_assemble(idx, src, 2)
    with pytest.raises(ValueError, match="no kernel"):
        window_merge(torch.zeros(2, 2, 2, dtype=torch.int32, device="meta"),
                     torch.zeros(2, 2, 2, device="meta"), torch.zeros(2, 1, 2, device="meta"),
                     src, 8, 4)


def test_cpu_tensors_run_the_plain_versions_and_count_no_launch():
    g = torch.Generator().manual_seed(0)
    q = torch.randint(-2, 3, (3, 16), generator=g).float()
    c = torch.randint(-2, 3, (1024, 16), generator=g).float()
    gsel = torch.tensor([[0, 3], [1, 7], [2, 5]])
    reset_launch_counts()
    for x, y in zip(stream_capture(q, c, 1000, 512, 2),
                    stream_capture_plain(q, c, 1000, 512, 2)):
        assert torch.equal(x, y)
    assert torch.equal(gather_groups(q, c, gsel), gather_groups_plain(q, c, gsel))
    exact_topk_mips(q, c, 5, chunk_size=512, on_miss="flag", select="capdom", impl="stream")
    for x, y in zip(group_max(q, c, 3), group_max_plain(q, c, 3)):
        assert torch.equal(x, y)
    assert set(launch_counts()) == {
        "stream_capture", "gather_groups", "stream_capture_int8", "gather_groups_int8",
        "stream_capture_int4", "gather_groups_int4", "stream_capture_pq4",
        "gather_groups_pq4", "score_gmax", "score_gmax_int8", "score_gmax_int4",
        "score_gmax_pq4", "score_gather", "cap_assemble", "window_merge", "group_max",
        "group_max_int8",
        "group_max_int4", "flash_attention", "flash_attention_bwd_dkv",
        "flash_attention_bwd_dq", "int4_matmul"}
    assert not any(launch_counts().values())


def test_wrappers_check_their_operands():
    q = torch.zeros(2, 16)
    with pytest.raises(ValueError, match="multiple of chunk_size"):
        stream_capture(q, torch.zeros(1000, 16), 1000, 512, 2)
    with pytest.raises(ValueError, match="capture budget"):
        stream_capture(q, torch.zeros(1024, 16), 1024, 512, 5)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gather_groups(q, torch.zeros(256, 16, dtype=torch.float16),
                      torch.zeros(2, 1, dtype=torch.int64))
    with pytest.raises(ValueError, match="gsel"):
        gather_groups(q, torch.zeros(256, 16), torch.zeros(3, 1, dtype=torch.int64))
    with pytest.raises(ValueError, match="multiple of 128"):
        group_max(q, torch.zeros(200, 16))
    with pytest.raises(ValueError, match="winners"):
        group_max(q, torch.zeros(256, 16), 129)


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_score_probe_runs_its_plain_version_on_the_cpu(quant):
    """The mma order's probe wrapper on CPU tensors: quant_scores of each
    tile's 32 rows and 8 queries, [T, 32, 8]; it counts no launch and
    refuses what the probe kernel does not take."""
    from kirag_tpu_torch.kernels.exact import quant_scores, score_probe

    g = torch.Generator().manual_seed(3)
    d = 256
    if quant == "int8":
        codes = torch.randint(-127, 128, (3, 32, d), generator=g).to(torch.int8)
        scales = torch.rand(3, 32, generator=g)
    else:
        codes = torch.randint(0, 256, (3, 32, d // 2), generator=g).to(torch.uint8)
        scales = torch.rand(3, 32, d // 128, generator=g)
    q = torch.randn(3, 8, d, generator=g)
    reset_launch_counts()
    out = score_probe(codes, scales, q, quant)
    assert out.shape == (3, 32, 8) and not any(launch_counts().values())
    for t in range(3):
        assert torch.equal(out[t], quant_scores(q[t], codes[t], scales[t], quant).T)
    with pytest.raises(ValueError, match="score_probe takes"):
        score_probe(codes[:, :16], scales[:, :16], q, quant)
    with pytest.raises(ValueError, match="do not match"):
        score_probe(codes, scales, q[:, :4], quant)


def test_group_max_plain_peels_ties_to_the_lowest_lane():
    """Scores 5, 5, 3 at lanes 7, 2, 9 of one group, everything else 0: the
    peel gives 5 (lane 2), 5 (lane 7), 3 (lane 9), then 0 at lane 0."""
    c = torch.zeros(256, 8)
    c[[7, 2], 0], c[9, 0], c[130, 0] = 5.0, 3.0, -1.0
    q = torch.zeros(1, 8)
    q[0, 0] = 1.0
    gmax, gidx = group_max_plain(q, c, 4)
    assert gmax[0, :, 0].tolist() == [5.0, 5.0, 3.0, 0.0]
    assert gidx[0, :, 0].tolist() == [2, 7, 9, 0]
    assert gmax[0, :, 1].tolist() == [0.0] * 4 and gidx[0, :, 1].tolist() == [0, 1, 3, 4]


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_bitwise_equal_plain_on_integer_data(cuda_device, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    n, d, chunk, k = 32768, 200, 4096, 50  # d: a multiple of 8, not of 32
    c = torch.randint(-2, 3, (n, d), generator=g, device=cuda_device).to(dtype)
    b = _capture_budget(k, n // chunk, chunk // 128)
    for n_q in (5, 8, 32):
        q = torch.randint(-2, 3, (n_q, d), generator=g, device=cuda_device).to(dtype)
        reset_launch_counts()
        got = stream_capture(q, c, n - 300, chunk, b)
        want = stream_capture_plain(q, c, n - 300, chunk, b)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
        gsel = torch.sort(hier_topk(got[0].reshape(-1, n_q).T, k)[1], dim=-1).values
        assert torch.equal(gather_groups(q, c, gsel), gather_groups_plain(q, c, gsel))
        counts = launch_counts()
        assert counts.pop("stream_capture") == 1 and counts.pop("gather_groups") == 1
        assert not any(counts.values())


def quantized_corpus(quant, n, d, g, device):
    """Random codes and power-of-two scales (int8: a scale a row; int4:
    packed nibbles and a scale per 128-dim block)."""
    if quant == "int8":
        codes = torch.randint(-127, 128, (n, d), generator=g, device=device).to(torch.int8)
        shape = (n,)
    else:
        codes = torch.randint(0, 256, (n, d // 2), generator=g, device=device).to(torch.uint8)
        shape = (n, d // 128)
    scales = torch.exp2(torch.randint(-9, -2, shape, generator=g, device=device).float())
    return codes, scales


@pytest.mark.cuda
@pytest.mark.parametrize("quant,d", [("int8", 208), ("int8", 1024), ("int4", 256),
                                     ("int4", 768), ("int4", 1024), ("int4", 1280),
                                     ("int4", 2048)])
def test_quantized_kernels_bitwise_equal_plain_on_integer_data(cuda_device, quant, d):
    """Small-integer queries (exact in bf16) and power-of-two scales: every
    score is exact in any summation order, so K1 and K2 equal their plain
    versions bitwise, and K1's captured groups equal K2's re-scores of them."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    n, chunk, k = 16384, 2048, 40
    c, s = quantized_corpus(quant, n, d, g, cuda_device)
    b = _capture_budget(k, n // chunk, chunk // 128)
    for n_q in (3, 8, 32):
        q = torch.randint(-2, 3, (n_q, d), generator=g, device=cuda_device).float()
        reset_launch_counts()
        got = stream_capture(q, c, n - 300, chunk, b, s, quant)
        want = stream_capture_plain(q, c, n - 300, chunk, b, s, quant)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
        gsel = torch.sort(hier_topk(got[0].reshape(-1, n_q).T, k)[1], dim=-1).values
        assert torch.equal(gather_groups(q, c, gsel, s, quant),
                           gather_groups_plain(q, c, gsel, s, quant))
        captured = got[2].permute(2, 0, 1).reshape(n_q, -1)            # [Q, C * b]
        rescored = gather_groups(q, c, captured, s, quant)
        assert torch.equal(rescored.view(n_q, -1, b, 128).transpose(0, 1),
                           got[1].view(-1, n_q, b, 128))
        counts = launch_counts()
        assert counts[f"stream_capture_{quant}"] == 1
        assert counts[f"gather_groups_{quant}"] == 2
        assert counts["stream_capture"] == counts["gather_groups"] == 0


QUANT_DEPTHS = [("int8", 208), ("int8", 1024), ("int4", 256), ("int4", 768), ("int4", 1024),
                ("int4", 1280), ("int4", 2048)]


@pytest.mark.cuda
@pytest.mark.parametrize("quant,d", QUANT_DEPTHS)
def test_quantized_k5_and_k7a_bitwise_equal_plain_on_integer_data(cuda_device, quant, d):
    """The int8/int4 K5 (W = 1, 2, 128) and K7a (three stores) on integer
    data, valid_rows mid-group: bitwise their plain versions, K7a's maxima
    bitwise K1's, K5's W = 1 values bitwise K1's unmasked maxima."""
    g = torch.Generator(device=cuda_device).manual_seed(15)
    n, chunk = 16384, 2048
    c, s = quantized_corpus(quant, n, d, g, cuda_device)
    for n_q in (3, 8, 32, 40):
        q = torch.randint(-2, 3, (n_q, d), generator=g, device=cuda_device).float()
        k1 = stream_capture(q, c, n - 300, chunk, 4, s, quant)[0]
        unmasked = stream_capture(q, c, n, chunk, 4, s, quant)[0]
        for store in ("chunk", "row", "none"):
            got = score_gmax(q, c, n - 300, chunk, store, s, quant)
            want = score_gmax_plain(q, c, n - 300, chunk, store, s, quant)
            assert torch.equal(got[1], want[1]) and torch.equal(got[1], k1), (n_q, store)
            if store != "none":
                assert torch.equal(got[0], want[0]), (n_q, store)
        for w in (1, 2, 128):
            got = group_max(q, c, w, s, quant)
            want = group_max_plain(q, c, w, s, quant)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (n_q, w)
            if w == 1:
                assert torch.equal(got[0][:, 0], unmasked.reshape(-1, n_q).T)


@pytest.mark.cuda
@pytest.mark.parametrize("quant,d", [("int8", 208), ("int8", 1024), ("int4", 1024),
                                     ("int4", 2048)])
def test_mma_order_is_the_same_at_every_place_of_the_fragments(cuda_device, quant, d):
    """The mma order assumes an output element depends on its row, its
    query and its running sum only. One (row, query) pair of random data is
    placed at each of the 32 x 8 places of a probe tile (two m16 A tiles,
    one n8 B tile), every other row and query random and different in each
    tile: the pair's score is the same bits at all 256 places, and equals
    the sweeps' score of the same pair (K1's maxima of a one-row group,
    K2's re-score with the query in column 0)."""
    from kirag_tpu_torch.kernels.exact import score_probe, score_probe_plain
    from kirag_tpu_torch.ops.quantized import quantize_rows_int4_torch, quantize_rows_int8_torch

    g = torch.Generator(device=cuda_device).manual_seed(17)
    quantize = quantize_rows_int8_torch if quant == "int8" else quantize_rows_int4_torch
    tiles = 32 * 8
    rows = torch.nn.functional.normalize(
        torch.randn(tiles * 32, d, generator=g, device=cuda_device), dim=-1)
    codes, scales = quantize(rows)
    codes = codes.view(tiles, 32, -1).clone()
    scales = scales.view(tiles, 32, *scales.shape[1:]).clone()
    queries = torch.nn.functional.normalize(
        torch.randn(tiles, 8, d, generator=g, device=cuda_device), dim=-1)
    m_of = torch.arange(tiles, device=cuda_device) // 8
    n_of = torch.arange(tiles, device=cuda_device) % 8
    t = torch.arange(tiles, device=cuda_device)
    row, row_scale, query = codes[0, 0].clone(), scales[0, 0].clone(), queries[0, 0].clone()
    codes[t, m_of], scales[t, m_of], queries[t, n_of] = row, row_scale, query
    out = score_probe(codes, scales, queries, quant)
    plain = score_probe_plain(codes, scales, queries, quant)
    torch.cuda.synchronize()
    pair = out[t, m_of, n_of]
    assert torch.equal(pair, pair[:1].expand(tiles)), pair.unique()
    assert float((out - plain).abs().max()) <= 1e-5
    # the sweeps and the gather place the pair elsewhere: same bits
    c = torch.zeros((128, codes.shape[2]), dtype=codes.dtype, device=cuda_device)
    c[:] = codes[0, 0]
    sc = scales[0, 0].expand(128, *scales.shape[2:]).contiguous()
    q = queries[0, :1].expand(3, d).contiguous()
    k1 = stream_capture(q, c, 128, 128, 1, sc, quant)[0]
    cand = gather_groups(q, c, torch.zeros((3, 1), dtype=torch.int32, device=cuda_device), sc,
                         quant)
    assert torch.equal(k1.reshape(3), pair[:3])
    assert torch.equal(cand.reshape(3, 128), pair[:1].expand(3, 128))


@pytest.mark.cuda
@pytest.mark.parametrize("quant,d", [("int8", 1024), ("int4", 1024), ("int4", 2048)])
def test_quantized_kernels_agree_bitwise_on_random_data(cuda_device, quant, d):
    """Random unit rows quantized on the card, unit queries (sums round, so
    only one order gives the same bits), valid_rows mid-group, many chunks:
    K1's capture bitwise K2's re-scores, K7a's maxima bitwise K1's and its
    scores of the captured groups bitwise K2's, K5's W = 1 values bitwise
    K1's unmasked maxima, a second launch bitwise the first."""
    from kirag_tpu_torch.ops.quantized import quantize_rows_int4_torch, quantize_rows_int8_torch

    g = torch.Generator(device=cuda_device).manual_seed(19)
    n, chunk, b = 32768, 2048, 4
    rows = torch.nn.functional.normalize(
        torch.randn(n, d, generator=g, device=cuda_device), dim=-1)
    c, s = (quantize_rows_int8_torch if quant == "int8" else quantize_rows_int4_torch)(rows)
    valid, n_c = n - 70, n // chunk
    for n_q in (1, 8, 9, 32, 33):
        q = torch.nn.functional.normalize(
            torch.randn(n_q, d, generator=g, device=cuda_device), dim=-1)
        k1 = stream_capture(q, c, valid, chunk, b, s, quant)
        assert all(torch.equal(x, y)
                   for x, y in zip(k1, stream_capture(q, c, valid, chunk, b, s, quant)))
        gmax, capture, gids = k1[:3]
        gsel = gids.permute(2, 0, 1).reshape(n_q, -1)
        cand = gather_groups(q, c, gsel, s, quant)
        assert torch.equal(cand, capture.view(n_c, n_q, b, 128).transpose(0, 1)
                           .reshape(n_q, -1, 128)), n_q
        scores, k7 = score_gmax(q, c, valid, chunk, "chunk", s, quant)
        assert torch.equal(k7, gmax), n_q
        assert torch.equal(score_gather(scores, gsel), cand), n_q
        unmasked = stream_capture(q, c, n, chunk, b, s, quant)[0]
        assert torch.equal(group_max(q, c, 1, s, quant)[0][:, 0], unmasked.reshape(-1, n_q).T)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_kernels_match_plain_on_random_data(cuda_device, quant):
    """Unit rows quantized on the card and unit queries: f32 sums of 1024
    exact products in two orders, within 1e-5."""
    from kirag_tpu_torch.ops.quantized import quantize_rows_int4_torch, quantize_rows_int8_torch

    g = torch.Generator(device=cuda_device).manual_seed(6)
    rows = torch.nn.functional.normalize(
        torch.randn(16384, 1024, generator=g, device=cuda_device), dim=-1)
    quantize = quantize_rows_int8_torch if quant == "int8" else quantize_rows_int4_torch
    c, s = quantize(rows)
    q = rows[torch.arange(0, 16384, 1001, device=cuda_device)]     # 17 stored rows
    b = _capture_budget(50, 8, 16)
    got = stream_capture(q, c, 16000, 2048, b, s, quant)
    want = stream_capture_plain(q, c, 16000, 2048, b, s, quant)
    for i in (0, 3, 4):  # gmax, capmax, resid (-inf where every group is captured)
        torch.testing.assert_close(got[i], want[i], atol=1e-5, rtol=0)
    # captured scores where both peeled the same group (a near-tie may swap two)
    same = (got[2] == want[2]).permute(0, 2, 1).repeat_interleave(128, dim=2)
    assert float((got[1] - want[1]).abs()[same].max()) <= 1e-5
    gsel = torch.sort(hier_topk(got[0].reshape(-1, len(q)).T, 50)[1], dim=-1).values
    diff = gather_groups(q, c, gsel, s, quant) - gather_groups_plain(q, c, gsel, s, quant)
    assert float(diff.abs().max()) <= 1e-5
    vals, idx, ok = exact_topk_mips(q, c, 10, chunk_size=2048, on_miss="flag", scales=s,
                                    select="capdom", impl="stream")
    assert bool(ok) and torch.equal(idx[:, 0], torch.arange(0, 16384, 1001, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
def test_exact_search_on_the_card_matches_plain(cuda_device, quant):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    if quant == "none":
        c = torch.randint(-3, 4, (20000, 64), generator=g, device=cuda_device).float()
        s, d = None, 64
    else:
        d = 256
        c, s = quantized_corpus(quant, 20000, d, g, cuda_device)
    q = torch.zeros(8, d, device=cuda_device)
    q[:3] = torch.randint(-3, 4, (3, d), generator=g, device=cuda_device).float()
    for on_miss in ("flag", "fallback"):  # zero rows: the flag fails, K2 runs
        got = exact_topk_mips(q, c, 30, chunk_size=2048, valid_rows=19000, on_miss=on_miss,
                              scales=s, select="capdom", impl="stream")
        want = exact_topk_mips(q, c, 30, chunk_size=2048, valid_rows=19000,
                               on_miss=on_miss, plain=True, scales=s, select="capdom",
                               impl="stream")
        for x, y in zip(got, want):
            assert torch.equal(x, y)


def pq4_corpus(n, d, m, g, device, integer):
    """Random 4-bit PQ codes [n, m/2] and a [16, d] level table: small
    integers (exact in bf16, so every score is exact in any order), or
    normal values of a unit row's scale."""
    codes = torch.randint(0, 256, (n, m // 2), generator=g, device=device).to(torch.uint8)
    if integer:
        table = torch.randint(-3, 4, (16, d), generator=g, device=device).float()
    else:
        table = torch.randn(16, d, generator=g, device=device) / math.sqrt(d)
    return codes, table


@pytest.mark.cuda
@pytest.mark.parametrize("d,m", [(1024, 128), (1024, 256), (1024, 512), (512, 512),
                                 (384, 96), (2048, 256), (2048, 1024)])
def test_pq4_kernels_bitwise_equal_plain_on_integer_data(cuda_device, d, m):
    """D / m = 1, 2, 4, 8 and m / 2 = 48-512 bytes a row: K1 and K2 with
    pq4 scoring equal their plain versions bitwise, K1's captures equal K2's
    re-scores, and the search equals the plain search."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    n, chunk, k = 16384, 2048, 40
    c, table = pq4_corpus(n, d, m, g, cuda_device, integer=True)
    b = _capture_budget(k, n // chunk, chunk // 128)
    for n_q in (3, 8, 32):
        q = torch.randint(-2, 3, (n_q, d), generator=g, device=cuda_device).float()
        reset_launch_counts()
        got = stream_capture(q, c, n - 300, chunk, b, table, "pq4")
        want = stream_capture_plain(q, c, n - 300, chunk, b, table, "pq4")
        for x, y in zip(got, want):
            assert torch.equal(x, y)
        gsel = torch.sort(hier_topk(got[0].reshape(-1, n_q).T, k)[1], dim=-1).values
        assert torch.equal(gather_groups(q, c, gsel, table, "pq4"),
                           gather_groups_plain(q, c, gsel, table, "pq4"))
        captured = got[2].permute(2, 0, 1).reshape(n_q, -1)
        rescored = gather_groups(q, c, captured, table, "pq4")
        assert torch.equal(rescored.view(n_q, -1, b, 128).transpose(0, 1),
                           got[1].view(-1, n_q, b, 128))
        counts = launch_counts()
        assert counts["stream_capture_pq4"] == 1 and counts["gather_groups_pq4"] == 2
        search = dict(chunk_size=chunk, valid_rows=n - 300, on_miss="flag", scales=table,
                      quant="pq4", select="capdom", impl="stream")
        for x, y in zip(exact_topk_mips(q, c, k, **search),
                        exact_topk_mips(q, c, k, plain=True, **search)):
            assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [128, 256, 512])
def test_pq4_kernels_match_plain_on_random_data(cuda_device, m):
    """Normal levels and unit queries: f32 sums in two orders, within 1e-6
    of the largest score (K1, K2 and K7a)."""
    g = torch.Generator(device=cuda_device).manual_seed(8)
    d = 1024
    c, table = pq4_corpus(16384, d, m, g, cuda_device, integer=False)
    q = torch.nn.functional.normalize(torch.randn(8, d, generator=g, device=cuda_device), dim=-1)
    b = _capture_budget(50, 8, 16)
    got = stream_capture(q, c, 16000, 2048, b, table, "pq4")
    want = stream_capture_plain(q, c, 16000, 2048, b, table, "pq4")
    scale = float(want[0].abs().max())
    for i in (0, 3):
        assert float((got[i] - want[i]).abs().max()) <= 1e-6 * scale
    same = (got[2] == want[2]).permute(0, 2, 1).repeat_interleave(128, dim=2)
    assert float((got[1] - want[1]).abs()[same].max()) <= 1e-6 * scale
    gsel = torch.sort(hier_topk(got[0].reshape(-1, 8).T, 50)[1], dim=-1).values
    diff = gather_groups(q, c, gsel, table, "pq4") - gather_groups_plain(q, c, gsel, table, "pq4")
    assert float(diff.abs().max()) <= 1e-6 * scale
    for store in ("chunk", "none"):  # K7a, the same order
        k7 = score_gmax(q, c, 16000, 2048, store, table, "pq4")
        k7_plain = score_gmax_plain(q, c, 16000, 2048, store, table, "pq4")
        assert float((k7[1] - k7_plain[1]).abs().max()) <= 1e-6 * scale
        if store == "chunk":
            assert float((k7[0] - k7_plain[0]).abs().max()) <= 1e-6 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("d,m", [(64, 8), (1536, 96), (4096, 512)])
def test_pq4_kernels_refuse_geometries_they_do_not_take(cuda_device, d, m):
    """m / 2 % 16 != 0, D / m = 16, D > 2048: refused, not launched; and K5
    takes no pq4 corpus (approximate search on PQ serves exact search)."""
    q, table = torch.zeros(2, d, device=cuda_device), torch.zeros(16, d, device=cuda_device)
    codes = torch.zeros(512, m // 2, dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="pq4 kernels"):
        stream_capture(q, codes, 512, 256, 1, table, "pq4")
    with pytest.raises(ValueError, match="no pq4"):
        group_max(q, codes, 1, table, "pq4")


PQ_REL = 1e-6  # random levels: a share of the largest score (f32 sums in two orders)
PQ_MMA_GEOMETRIES = [(1024, 128), (1024, 256), (1024, 512), (2048, 256), (2048, 2048)]


def pq_rel(m):
    """PQ_REL, for chains of m / 2 dims: the mma truncates each k-step's
    sum, so a chain's error grows with its m / 32 k-steps; PQ_REL holds to
    m = 512 (16 k-steps), four times it at m = 2048 (the card gave 1.3e-6
    of the largest score there)."""
    return PQ_REL * max(1, m // 512)


@pytest.mark.cuda
@pytest.mark.parametrize("d,m", PQ_MMA_GEOMETRIES)
def test_pq4_mma_order_is_the_same_at_every_place_of_the_fragments(cuda_device, d, m):
    """pq4's mma order: one (row, query) pair of random codes, levels and
    query at each of the 32 x 8 places of a probe tile (every other row and
    query random and different in each tile) gives one set of bits, within
    PQ_REL of the largest plain score, and the same bits in K1's maxima,
    K7a's and K2's re-score (the query at column 0), which place it
    elsewhere."""
    from kirag_tpu_torch.kernels.exact import score_probe, score_probe_plain

    g = torch.Generator(device=cuda_device).manual_seed(17)
    tiles = 32 * 8
    codes = torch.randint(0, 256, (tiles, 32, m // 2), generator=g, device=cuda_device).to(
        torch.uint8)
    table = torch.randn(16, d, generator=g, device=cuda_device) / math.sqrt(d)
    queries = torch.nn.functional.normalize(
        torch.randn(tiles, 8, d, generator=g, device=cuda_device), dim=-1)
    t = torch.arange(tiles, device=cuda_device)
    m_of, n_of = t // 8, t % 8
    row, query = codes[0, 0].clone(), queries[0, 0].clone()
    codes[t, m_of], queries[t, n_of] = row, query
    out = score_probe(codes, table, queries, "pq4")
    plain = score_probe_plain(codes, table, queries, "pq4")
    torch.cuda.synchronize()
    pair = out[t, m_of, n_of]
    assert torch.equal(pair, pair[:1].expand(tiles)), pair.unique()
    assert float((out - plain).abs().max()) <= pq_rel(m) * float(plain.abs().max())
    c = row.expand(128, m // 2).contiguous()
    q = query.expand(3, d).contiguous()
    k1 = stream_capture(q, c, 128, 128, 1, table, "pq4")[0]
    k7 = score_gmax(q, c, 128, 128, "chunk", table, "pq4")
    cand = gather_groups(q, c, torch.zeros((3, 1), dtype=torch.int32, device=cuda_device),
                         table, "pq4")
    assert torch.equal(k1.reshape(3), pair[:3]) and torch.equal(k7[1], k1)
    assert torch.equal(k7[0].reshape(3, 128), pair[:1].expand(3, 128))
    assert torch.equal(cand.reshape(3, 128), pair[:1].expand(3, 128))


@pytest.mark.cuda
@pytest.mark.parametrize("d,m", [(1024, 256), (1024, 128), (1024, 512), (2048, 1024)])
def test_pq4_kernels_agree_bitwise_on_random_data(cuda_device, d, m):
    """Random codes and levels, unit queries (sums round, so only one order
    gives the same bits), valid_rows mid-group, many chunks: K1's capture
    bitwise K2's re-scores, K7a's maxima bitwise K1's and its scores of the
    captured groups bitwise K2's, a second launch bitwise the first."""
    g = torch.Generator(device=cuda_device).manual_seed(19)
    n, chunk, b = 32768, 2048, 4
    c, table = pq4_corpus(n, d, m, g, cuda_device, integer=False)
    valid, n_c = n - 70, n // chunk
    for n_q in (1, 8, 9, 32, 33):
        q = torch.nn.functional.normalize(
            torch.randn(n_q, d, generator=g, device=cuda_device), dim=-1)
        k1 = stream_capture(q, c, valid, chunk, b, table, "pq4")
        assert all(torch.equal(x, y)
                   for x, y in zip(k1, stream_capture(q, c, valid, chunk, b, table, "pq4")))
        gmax, capture, gids = k1[:3]
        gsel = gids.permute(2, 0, 1).reshape(n_q, -1)
        cand = gather_groups(q, c, gsel, table, "pq4")
        assert torch.equal(cand, capture.view(n_c, n_q, b, 128).transpose(0, 1)
                           .reshape(n_q, -1, 128)), n_q
        scores, k7 = score_gmax(q, c, valid, chunk, "chunk", table, "pq4")
        assert torch.equal(k7, gmax), n_q
        assert torch.equal(score_gather(scores, gsel), cand), n_q


@pytest.mark.cuda
def test_pq4_calls_start_the_sweep_kernels(cuda_device):
    """One pq4 call of K1 starts capture_sweep_kernel and
    peel_capture_kernel, of K2 gather_mma_kernel, of K7a
    score_sweep_kernel, and nothing else (chip_smoke.py's count, in a
    process of its own, int8 and int4 beside them)."""
    import json
    import subprocess
    import sys

    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c",
                           "import chip_smoke; chip_smoke.quant_kernels_a_call()"],
                          cwd=root, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    want = {"stream_capture_pq4": ("capture_sweep_kernel", "peel_capture_kernel"),
            "gather_groups_pq4": ("gather_mma_kernel",),
            "score_gmax_pq4": ("score_sweep_kernel",)}
    for name, kernels in want.items():
        assert len(out[name]) == len(kernels), out
        assert all(k in got for k, got in zip(kernels, out[name])), out


def k5_corpus(fmt, n, d, g, device):
    """Integer data of one K5 format: small-integer float32/bfloat16 rows,
    or random codes with power-of-two scales."""
    if fmt in ("int8", "int4"):
        return (*quantized_corpus(fmt, n, d, g, device), fmt)
    c = torch.randint(-3, 4, (n, d), generator=g, device=device)
    return c.to(torch.float32 if fmt == "float32" else torch.bfloat16), None, "none"


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,d", [("float32", 200), ("bfloat16", 1040), ("int8", 208),
                                   ("int8", 1040), ("int4", 256), ("int4", 1280),
                                   ("int4", 2048)])
def test_group_max_bitwise_equal_plain_on_integer_data(cuda_device, fmt, d):
    """K5 on integer data (every score exact in any order, many ties): its
    values and lanes equal the plain version's bitwise at every W, and at
    W = 1 its values are K1's group maxima."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    n = 8192
    c, s, quant = k5_corpus(fmt, n, d, g, cuda_device)
    for n_q in (3, 8, 32):
        q = torch.randint(-2, 3, (n_q, d), generator=g, device=cuda_device).float()
        if quant == "none":
            q = q.to(c.dtype)
        k1_gmax = stream_capture(q, c, n, 2048, 1, s, quant)[0]           # [C, G, Q]
        for w in (1, 2, 8, 128):
            reset_launch_counts()
            got = group_max(q, c, w, s, quant)
            assert launch_counts()["group_max" if quant == "none" else f"group_max_{quant}"] == 1
            want = group_max_plain(q, c, w, s, quant)
            torch.cuda.synchronize()
            assert got[0].shape == (n_q, w, n // 128) and got[1].dtype == torch.int32
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (n_q, w)
            if w == 1:
                assert torch.equal(got[0][:, 0], k1_gmax.reshape(-1, n_q).T)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
def test_group_max_matches_plain_on_random_data(cuda_device, quant):
    """Unit rows (quantized on the card) and unit queries: values within
    1e-5 (f32 sums of 1024 products in two orders); lanes equal wherever the
    peeled value stands more than that from the group's other scores."""
    from kirag_tpu_torch.ops.quantized import quantize_rows_int4_torch, quantize_rows_int8_torch

    g = torch.Generator(device=cuda_device).manual_seed(8)
    rows = torch.nn.functional.normalize(
        torch.randn(16384, 1024, generator=g, device=cuda_device), dim=-1)
    c, s = rows, None
    if quant != "none":
        c, s = (quantize_rows_int8_torch if quant == "int8" else quantize_rows_int4_torch)(rows)
    q = torch.nn.functional.normalize(torch.randn(16, 1024, generator=g, device=cuda_device),
                                      dim=-1)
    got = group_max(q, c, 8, s, quant)
    want = group_max_plain(q, c, 9, s, quant)       # the 9th: the last winner's rival
    torch.cuda.synchronize()
    assert float((got[0] - want[0][:, :8]).abs().max()) <= 1e-5
    gap = want[0][:, :-1] - want[0][:, 1:]                              # [Q, 8, G]
    clear = gap > 1e-5
    clear[:, 1:] &= gap[:, :-1] > 1e-5
    assert torch.equal(got[1][clear], want[1][:, :8][clear])


@pytest.mark.cuda
def test_approx_search_refuses_an_off_grid_cuda_corpus(cuda_device):
    """On the card the corpus must come on the 128-row grid: padding it
    would copy the corpus on every search."""
    from kirag_tpu_torch.ops.approx import approx_topk_mips

    c = torch.ones((200, 64), device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 128"):
        approx_topk_mips(torch.ones((2, 64), device=cuda_device), c, 4)
    vals, idx = approx_topk_mips(torch.ones((2, 64), device=cuda_device), c[:128], 4)
    assert idx[:, 0].tolist() == [0, 0] and vals[:, 1:].isinf().all()


def bf16_ulps(x: torch.Tensor, n: int = 2) -> float:
    """n bf16 ulps at the largest magnitude of x (8 significant bits)."""
    return n * 2.0 ** (math.floor(math.log2(float(x.abs().max()))) - 7)


BWD_LAYOUTS = ("padded", "all_padding", "packed_on_edges", "non_monotonic", "all_real")


def bwd_segments(kind: str, b: int, t: int, device) -> torch.Tensor:
    """[b, t] segment ids of one kind for every row: right-padded (lengths
    that end inside a tile, on a tile edge, after one token, and none);
    padding only; packed documents whose boundaries fall on 64-row tile
    edges (with a padding tile last in one row); ids that are not monotonic
    across tiles (1, 2, 1 by tile, so a tile pairs with one two tiles away
    and not with the one between; 3, 2, 1; and ids alternating inside
    tiles); every token real."""
    pos = torch.arange(t, device=device)
    tile = pos // 64
    seg = torch.ones(b, t, dtype=torch.int32, device=device)
    for i in range(b):
        if kind == "padded":
            seg[i, (t - 37, t - 64 * (t // 128) if t > 64 else 32, 1, t)[i % 4]:] = 0
        elif kind == "all_padding":
            seg[i] = 0
        elif kind == "packed_on_edges":
            seg[i] = 1 + tile // (1 + i % 2)
            if i % 4 == 3 and t > 64:
                seg[i, t - 64:] = 0
        elif kind == "non_monotonic":
            seg[i] = (torch.tensor([1, 2, 1], device=device)[tile % 3],
                      3 - tile % 3,
                      1 + (pos // 48) % 2,
                      torch.tensor([2, 1, 2], device=device)[tile % 3])[i % 4]
    return seg


@pytest.mark.cuda
@pytest.mark.parametrize("strided", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [64, 128, 192, 256, 512])
@pytest.mark.parametrize("layout", BWD_LAYOUTS)
def test_flash_attention_matches_plain(cuda_device, layout, t, dtype, strided):
    """The forward kernel against the plain version: out f32 within 1e-5
    (atol and rtol; logits of sd 4, f32 sums in two orders, exponentials),
    bf16 within 2 bf16 ulps of the largest magnitude; lse within 1e-5 of the
    plain logsumexp; a second launch bitwise the first. Every T a multiple of
    64 (the f32 kernel's 128-query blocks half full at odd multiples), the
    segment layouts the tile skip works on, q, k, v as strided views of one
    fused projection (as the encoder passes them) or contiguous."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    b, h = 4, 4
    seg = bwd_segments(layout, b, t, cuda_device)
    qkv = 2.0 * torch.randn(b, t, 3 * h * 64, generator=g, device=cuda_device)
    q, k, v = (x.view(b, t, h, 64).transpose(1, 2) for x in qkv.to(dtype).split(h * 64, -1))
    if not strided:
        q, k, v = (x.contiguous() for x in (q, k, v))
    reset_launch_counts()
    got = flash_attention(q, k, v, seg, 0.125)
    assert launch_counts()["flash_attention"] == 1
    again, lse = _forward(q, k, v, seg, 0.125, with_lse=True)
    want, want_lse = flash_attention_plain(q, k, v, seg, 0.125, return_lse=True)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.transpose(1, 2).is_contiguous()
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        assert float((got.float() - want.float()).abs().max()) <= bf16_ulps(want)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)
    assert torch.equal(got, again), "two launches on the same inputs differ"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [64, 128, 192, 256, 512])
@pytest.mark.parametrize("layout", BWD_LAYOUTS)
def test_flash_attention_backward_matches_plain(cuda_device, dtype, t, layout):
    """dq, dk, dv through the forward and the two backward kernels against
    the plain backward on the plain forward's residuals: f32 within 1e-4 of
    each tensor's largest magnitude (f32 sums in other orders), bf16 within
    2^-6 of it (P and dS rounded to bf16 in both, exponentials and sums in
    other orders). Every T a multiple of 64 (odd multiples take the 64-row
    bf16 blocks), segment layouts whose tile ranges the bf16 kernels skip
    by, q, k, v as strided views of one fused projection; a second backward
    on the same inputs gives the same bits."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    b, h = 4, 4
    seg = bwd_segments(layout, b, t, cuda_device)
    qkv = torch.randn(b, t, 3 * h * 64, generator=g, device=cuda_device).to(dtype)
    q, k, v = (x.view(b, t, h, 64).transpose(1, 2).requires_grad_()
               for x in qkv.split(h * 64, -1))
    w = torch.randn(b, h, t, 64, generator=g, device=cuda_device).to(dtype)
    reset_launch_counts()
    out = flash_attention(q, k, v, seg, 0.125)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), w, retain_graph=True)
    counts = launch_counts()
    assert (counts["flash_attention"], counts["flash_attention_bwd_dkv"],
            counts["flash_attention_bwd_dq"]) == (1, 1, 1)
    again = torch.autograd.grad(out, (q, k, v), w)
    with torch.no_grad():
        o, lse = flash_attention_plain(q, k, v, seg, 0.125, return_lse=True)
        want = flash_attention_bwd_plain(q, k, v, seg, o, lse, w, 0.125)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -6
    for name, x, y, z in zip(("dq", "dk", "dv"), got, want, again):
        assert x.dtype == dtype and torch.isfinite(x).all(), name
        err = float((x.float() - y.float()).abs().max())
        assert err <= tol * float(y.float().abs().max()), (name, err)
        assert torch.equal(x, z), f"{name}: two launches on the same inputs differ"


def bwd_kernels_and_plain(device, dtype, t, seg, seed):
    """dq, dk, dv through flash_attention_bwd_dq/_dkv and through the plain
    backward on the plain forward's residuals, q, k, v strided views of one
    fused projection (b = 4, h = 4)."""
    g = torch.Generator(device=device).manual_seed(seed)
    b, h = seg.shape[0], 4
    qkv = torch.randn(b, t, 3 * h * 64, generator=g, device=device).to(dtype)
    q, k, v = (x.view(b, t, h, 64).transpose(1, 2) for x in qkv.split(h * 64, -1))
    do = torch.randn(b, h, t, 64, generator=g, device=device).to(dtype)
    o, lse = flash_attention_plain(q, k, v, seg, 0.125, return_lse=True)
    di = torch.sum(o.float() * do.float(), dim=-1)
    dk, dv = flash_attention_bwd_dkv(q, k, v, seg, lse, di, do, 0.125)
    dq = flash_attention_bwd_dq(q, k, v, seg, lse, di, do, 0.125)
    want = flash_attention_bwd_plain(q, k, v, seg, o, lse, do, 0.125)
    torch.cuda.synchronize()
    return (dq, dk, dv), want


@pytest.mark.cuda
@pytest.mark.parametrize("t", [64, 128, 192, 256, 512])
@pytest.mark.parametrize("layout", BWD_LAYOUTS)
def test_flash_attention_backward_f32_is_f32_grade(cuda_device, t, layout):
    """The f32 kernels take their products as split TF32 (three passes):
    dq, dk, dv within 1e-5 of each tensor's largest magnitude of the plain
    backward (f32 on the CUDA cores), ten times tighter than the 1e-4 check
    above; one TF32 pass would miss it by about 50x (tests/
    test_torch_flash_bwd_tf32.py models both)."""
    seg = bwd_segments(layout, 4, t, cuda_device)
    got, want = bwd_kernels_and_plain(cuda_device, torch.float32, t, seg, 5)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert x.dtype == torch.float32 and torch.isfinite(x).all(), name
        err = float((x - y).abs().max())
        assert err <= 1e-5 * float(y.abs().max()), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_when_each_tile_keeps_only_itself(cuda_device, dtype):
    """Every 64-row tile its own segment: each block's ring holds its own
    tile alone and skips every other; the gradients still match the plain
    backward (f32 within 1e-5, bf16 2^-6 of each largest magnitude)."""
    t = 256
    seg = (1 + torch.arange(t, device=cuda_device, dtype=torch.int32) // 64).repeat(4, 1)
    got, want = bwd_kernels_and_plain(cuda_device, dtype, t, seg, 6)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -6
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert x.dtype == dtype and torch.isfinite(x).all(), name
        err = float((x.float() - y.float()).abs().max())
        assert err <= tol * float(y.float().abs().max()), (name, err)


@pytest.mark.cuda
def test_flash_attention_backward_f32_is_one_kernel_each(cuda_device):
    """The profiler sees one dkv_tf32_kernel and one dq_tf32_kernel for an
    f32 backward, and nothing of the CUDA-core loops they replaced."""
    from torch.profiler import ProfilerActivity, profile

    seg = bwd_segments("padded", 4, 256, cuda_device)
    bwd_kernels_and_plain(cuda_device, torch.float32, 256, seg, 7)  # builds, warms up
    g = torch.Generator(device=cuda_device).manual_seed(7)
    q, k, v, do = (torch.randn(4, 4, 256, 64, generator=g, device=cuda_device)
                   for _ in range(4))
    lse = torch.randn(4, 4, 256, generator=g, device=cuda_device)
    di = torch.randn(4, 4, 256, generator=g, device=cuda_device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        flash_attention_bwd_dkv(q, k, v, seg, lse, di, do, 0.125)
        flash_attention_bwd_dq(q, k, v, seg, lse, di, do, 0.125)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("dkv_tf32_kernel" in n for n in names) == 1, names
    assert sum("dq_tf32_kernel" in n for n in names) == 1, names
    assert not any("_f32_kernel" in n for n in names), names


def int4_abs_sum(x, packed, scales, codebook=None):
    """sum_i |x_i| |w_i| s per output: the scale of the f32 rounding error
    that two summation orders of the same products can differ by."""
    half, out_dim = packed.shape
    lo, hi = (p.abs() for p in dequant_nibbles(packed, codebook))
    xf = x.reshape(-1, 2 * half).float().abs()
    w = torch.stack([lo, hi], dim=1).reshape(2 * half, out_dim)
    w = w * scales.float().repeat_interleave(64, dim=0)
    return xf @ w


def assert_int4_close(got, want, abs_sum):
    """bf16: at most 1 bf16 ulp of |want| at each element (two f32 sums in
    another order, rounded once); both dtypes: or within 2^-18 of the sum of
    the products' magnitudes, the f32 rounding bound near zero."""
    diff = (got.float() - want.float()).abs()
    f32_bound = abs_sum * 2.0 ** -18
    if got.dtype == torch.bfloat16:
        mag = want.float().abs().clamp_min(2.0 ** -126)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        bound = torch.maximum(ulp, f32_bound)
    else:
        bound = f32_bound
    assert bool((diff <= bound).all()), float((diff - bound).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nf4", [False, True])
@pytest.mark.parametrize("rows", [1, 2, 3, 4, 5, 8, 9, 16, 17, 24, 31, 32, 40])
@pytest.mark.parametrize("half,out_dim", [(256, 128), (512, 1536), (2048, 1024), (7168, 128)])
def test_int4_matmul_matches_plain(cuda_device, dtype, nf4, rows, half, out_dim):
    """Every row count of the tensor-core tiles (1-8, 9-16, 17-24, 25-32
    rows; 40 takes a second block row), one column tile over down_proj's
    depth (a cluster of 16 splits), every byte value; a second launch on the
    same inputs is bitwise the first (splits added in a fixed order)."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    packed = torch.randint(0, 256, (half, out_dim), generator=g, device=cuda_device,
                           dtype=torch.uint8)
    scales = torch.rand(half // 32, out_dim, generator=g, device=cuda_device) * 0.01
    cb = torch.linspace(-1, 1, 16, device=cuda_device) if nf4 else None
    x = torch.randn(rows, 2 * half, generator=g, device=cuda_device).to(dtype)
    reset_launch_counts()
    got = int4_matmul(x, packed, scales, cb)
    assert launch_counts()["int4_matmul"] == 1
    want = int4_matmul_plain(x, packed, scales, cb)
    again = int4_matmul(x, packed, scales, cb)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (rows, out_dim)
    assert torch.isfinite(got).all()
    assert_int4_close(got, want, int4_abs_sum(x, packed, scales, cb))
    assert torch.equal(got, again), "two launches on the same inputs differ"


@pytest.mark.cuda
@pytest.mark.parametrize("change", [{"steps": 2}, {"cluster": 8}, {"cluster": 32, "steps": 2},
                                    {"row_blocks": 2}, {"col_blocks": 4}, {"tiles": 5}])
def test_int4_matmul_refuses_a_plan_that_misses_the_call(cuda_device, change):
    """The kernel takes ``qmm.plan``'s cut whole and refuses one that would
    skip or repeat scale blocks, rows or columns, or pass its limits."""
    import dataclasses

    from kirag_tpu_torch.kernels import qmm

    g = torch.Generator(device=cuda_device).manual_seed(3)
    packed = torch.randint(0, 256, (2048, 1024), generator=g, device=cuda_device,
                           dtype=torch.uint8)
    scales = torch.rand(64, 1024, generator=g, device=cuda_device)
    x = torch.randn(4, 4096, generator=g, device=cuda_device).to(torch.bfloat16)
    good = qmm.plan(4, 2048, 1024, False)
    assert (good.cluster, good.steps) == (16, 4)
    qmm.launch(x, packed, scales, None, good)
    with pytest.raises(RuntimeError, match="int4_matmul kernel launch failed"):
        qmm.launch(x, packed, scales, None, dataclasses.replace(good, **change))


# ------------------------------------------- the exact-search variants' kernels


def corpus_of(fmt, n, d, g, device):
    """Integer-valued corpus rows in one of the five formats (every score is
    exact in any summation order): (corpus, scales, quant)."""
    if fmt in ("float32", "bfloat16"):
        c = torch.randint(-2, 3, (n, d), generator=g, device=device)
        return c.to(getattr(torch, fmt)), None, "none"
    if fmt == "pq4":
        c, table = pq4_corpus(n, d, d // 4, g, device, integer=True)
        return c, table, "pq4"
    c, s = quantized_corpus(fmt, n, d, g, device)
    return c, s, fmt


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["float32", "bfloat16", "int8", "int4", "pq4"])
def test_score_gmax_bitwise_equal_plain_and_k1(cuda_device, fmt):
    """K7a in its three stores: scores and maxima bitwise the plain
    version's, the maxima bitwise K1's, and the scores of K1's captured
    groups bitwise its capture (one scoring routine)."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    n, d, chunk = 16384, 256, 2048
    c, s, quant = corpus_of(fmt, n, d, g, cuda_device)
    for n_q in (3, 8, 32):
        q = torch.randint(-2, 3, (n_q, d), generator=g, device=cuda_device).float()
        if fmt == "bfloat16":
            q = q.to(torch.bfloat16)
        k1 = stream_capture(q, c, n - 300, chunk, 8, s, quant)
        for store in ("chunk", "row", "none"):
            reset_launch_counts()
            got = score_gmax(q, c, n - 300, chunk, store, s, quant)
            want = score_gmax_plain(q, c, n - 300, chunk, store, s, quant)
            name = "score_gmax" if quant == "none" else f"score_gmax_{quant}"
            assert launch_counts()[name] == 1
            assert torch.equal(got[1], want[1]) and torch.equal(got[1], k1[0])
            if store == "none":
                assert got[0] is None
                continue
            assert torch.equal(got[0], want[0])
            chunked = got[0] if store == "chunk" else got[0].view(n_q, -1, chunk).transpose(0, 1)
            cap = score_gather(chunked.contiguous(), k1[2].permute(2, 0, 1).reshape(n_q, -1))
            assert torch.equal(cap.view(n_q, -1, 8, 128).transpose(0, 1),
                               k1[1].view(-1, n_q, 8, 128))


def unit_rows(n, d, g, device, dtype):
    """Seeded random unit rows (not integers: sums round, so only one fma
    order gives the same bits)."""
    x = torch.randn(n, d, generator=g, device=device)
    return torch.nn.functional.normalize(x, dim=-1).to(dtype)


def peel_of(gmax, b):
    """K1's gids, capmax and resid as the peel of its own maxima gmax
    [C, G, Q]: larger maximum first, ties to the lower group id."""
    n_c, groups, n_q = gmax.shape
    vals, idx = torch.sort(gmax.transpose(1, 2), dim=-1, descending=True, stable=True)
    gids = idx[..., :b] + torch.arange(n_c, device=gmax.device).view(-1, 1, 1) * groups
    resid = vals[..., b] if b < groups else torch.full((n_c, n_q), float("-inf"),
                                                       device=gmax.device)
    return (gids.to(torch.int32).transpose(1, 2), vals[..., :b].transpose(1, 2),
            resid[:, None, :])


FLOAT_LAYOUTS = {  # name: (rows, chunk, capture budget b)
    "one chunk, b = G": (16384, 16384, 128),
    "one chunk, b << G": (16384, 16384, 8),
    "16 chunks of 16 groups": (32768, 2048, 4),
}


@pytest.mark.cuda
@pytest.mark.parametrize("layout", list(FLOAT_LAYOUTS))
@pytest.mark.parametrize("d", [200, 1024, 1040])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_float_sweeps_bitwise_equal_k2_and_k5_on_random_rows(cuda_device, dtype, d, layout):
    """The float K1 and K7a (search_plan's cuts) on random unit rows, with
    D off the 32-column tile (200, 1040), valid_rows mid-group, all-zero
    corpus and query rows: K1's capture bitwise K2's re-score of the captured
    groups, its gids/capmax/resid the peel of its own maxima, K7a's maxima
    bitwise K1's (unclamped: no score reaches FIN_MIN) and its scores of those
    groups bitwise K2's, K5's W = 1 values bitwise K1's unmasked maxima, a
    second launch bitwise the first, the maxima within 1e-4 of the plain
    version (another summation order)."""
    n, chunk, b = FLOAT_LAYOUTS[layout]
    g = torch.Generator(device=cuda_device).manual_seed(21)
    c = unit_rows(n, d, g, cuda_device, dtype)
    c[5] = 0
    c[n - 100:] = 0  # the indexer pads a corpus with zero rows
    valid = n - 70
    n_c, groups = n // chunk, chunk // 128
    for n_q in (1, 3, 8, 9, 16, 31, 32, 33, 64):
        q = unit_rows(n_q, d, g, cuda_device, dtype)
        q[-1] = 0  # the indexer pads a query batch with zero rows
        reset_launch_counts()
        k1 = stream_capture(q, c, valid, chunk, b)
        assert all(torch.equal(x, y) for x, y in zip(k1, stream_capture(q, c, valid, chunk, b)))
        gmax, capture, gids, capmax, resid = k1
        for x, y in zip((gids, capmax, resid), peel_of(gmax, b)):
            assert torch.equal(x, y), (n_q, "peel")
        gsel = gids.permute(2, 0, 1).reshape(n_q, -1)
        cand = gather_groups(q, c, gsel)
        assert torch.equal(cand, capture.view(n_c, n_q, b, 128).transpose(0, 1)
                           .reshape(n_q, -1, 128)), (n_q, "capture vs K2")
        scores, k7 = score_gmax(q, c, valid, chunk, "chunk")
        assert torch.equal(k7, gmax), (n_q, "K7a maxima")
        assert torch.equal(score_gather(scores, gsel), cand), (n_q, "K7a scores vs K2")
        rows, k7_row = score_gmax(q, c, valid, chunk, "row")
        assert torch.equal(k7_row, gmax)
        assert torch.equal(rows.view(n_q, n_c, chunk).transpose(0, 1), scores)
        assert score_gmax(q, c, valid, chunk, "none")[0] is None
        unmasked = stream_capture(q, c, n, chunk, b)[0]
        assert torch.equal(group_max(q, c, 1)[0][:, 0], unmasked.reshape(-1, n_q).T)
        plain = stream_capture_plain(q, c, valid, chunk, b)
        assert float((gmax - plain[0]).abs().max()) <= 1e-4
        counts = launch_counts()
        assert counts["stream_capture"] == 3 and counts["score_gmax"] == 3
        assert counts["gather_groups"] == 1 and counts["group_max"] == 1


@pytest.mark.cuda
def test_float_sweeps_refuse_a_cut_that_misses_the_call(cuda_device):
    """The float K1 and K7a take search_plan's cut whole and refuse one that
    leaves a group unscored or a range empty, K1's slots off min(b, gpb), or
    a shared-memory figure that is not the launch's own."""
    from kirag_tpu_torch.kernels import exact as kx

    c = torch.zeros(4096, 64, device=cuda_device)
    q = torch.zeros(8, 64, device=cuda_device)
    good = kx.search_plan(8, 2, 16, 4, 4)
    bad = [dataclasses.replace(good, splits=good.splits - 1),
           dataclasses.replace(good, splits=good.splits + 1),
           dataclasses.replace(good, slots=good.slots + 1),
           dataclasses.replace(good, smem=good.smem + 16)]
    k7a = kx.search_plan(8, 2, 16, 4)
    old = kx.search_plan
    try:
        for cut in bad:
            kx.search_plan = lambda *args, _cut=cut: _cut
            with pytest.raises(RuntimeError, match="stream_capture kernel launch failed"):
                stream_capture(q, c, 4096, 2048, 4)
        for cut in (dataclasses.replace(k7a, groups_per_block=3),
                    dataclasses.replace(k7a, smem=k7a.smem - 16)):
            kx.search_plan = lambda *args, _cut=cut: _cut
            with pytest.raises(RuntimeError, match="score_gmax kernel launch failed"):
                score_gmax(q, c, 4096, 2048, "chunk")
    finally:
        kx.search_plan = old


# K5 on float corpora: search_plan's cut of one chunk, each group peeled in
# registers (the reference's rounds up to 24 winners, a sort above)
K5_QUERIES = (1, 3, 8, 9, 17, 32, 33, 64)
K5_WINNERS = (1, 2, 8, 24, 25, 33, 128)
K5_GROUPS = 1003  # search_plan leaves the last range 3 groups short at every Q


def k5_lanes_clear(want, w, tol):
    """Where the plain version's winner r of W stands more than ``tol`` from
    the winners before and after it (``want`` peeled one further where W <
    128), so that another summation order cannot swap its lane."""
    vals = want[0]
    nxt = torch.cat([vals[:, 1:], torch.full_like(vals[:, :1], float("-inf"))], dim=1)[:, :w]
    gap = vals[:, :w] - nxt
    clear = gap > tol
    clear[:, 1:] &= gap[:, :-1] > tol
    return clear


@pytest.mark.cuda
@pytest.mark.parametrize("d", [200, 1024, 1040])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_float_group_max_bitwise_equal_plain_at_the_plans_cuts(cuda_device, dtype, d):
    """The float K5 on integer data (every score exact in any order, many
    ties) at search_plan's cuts, ragged last range included, Q = 1-64, W =
    1, 2, 8, 24 (the rounds), 25, 33 and 128 (the sort): values and lanes bitwise the
    plain version's, one launch a call, a second launch bitwise the first;
    then with positive queries over rows of -3e38, a group scoring -inf
    throughout and one with 64 finite scores (fewer than W); then one group
    (N = 128)."""
    from kirag_tpu_torch.kernels.exact import search_plan

    g = torch.Generator(device=cuda_device).manual_seed(31)
    c = torch.randint(-3, 4, (K5_GROUPS * 128, d), generator=g, device=cuda_device).to(dtype)
    c_inf = c.clone()
    c_inf[128:320] = -3e38  # group 1 and the first half of group 2
    ragged = set()
    for n_q in K5_QUERIES:
        p = search_plan(n_q, 1, K5_GROUPS, c.element_size())
        if K5_GROUPS % p.groups_per_block:
            ragged.add(n_q)
        signed = torch.randint(-2, 3, (n_q, d), generator=g, device=cuda_device).to(dtype)
        positive = torch.randint(1, 3, (n_q, d), generator=g, device=cuda_device).to(dtype)
        for corpus, q in ((c, signed), (c_inf, positive), (c[:128], signed),
                          (c_inf[128:256], positive)):
            for w in K5_WINNERS:
                reset_launch_counts()
                got = group_max(q, corpus, w)
                assert launch_counts()["group_max"] == 1
                again = group_max(q, corpus, w)
                want = group_max_plain(q, corpus, w)
                torch.cuda.synchronize()
                assert got[0].shape == (n_q, w, corpus.shape[0] // 128)
                assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (n_q, w)
                assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
        if n_q == 64:
            tail = group_max(positive, c_inf, 128)
            assert bool(torch.isinf(tail[0][:, :, 1]).all())
            assert int(torch.isfinite(tail[0][:, :, 2]).sum(1).max()) == 64
    assert ragged == set(K5_QUERIES)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [200, 1024, 1040])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_float_group_max_matches_plain_on_random_rows(cuda_device, dtype, d):
    """The float K5 on random unit rows: W = 1 values bitwise K1's unmasked
    maxima (one fma order), values within 1e-4 of the plain version's (another
    summation order), lanes equal wherever the winner stands more than that
    from its neighbours, a second launch bitwise the first."""
    g = torch.Generator(device=cuda_device).manual_seed(32)
    n = K5_GROUPS * 128
    c = unit_rows(n, d, g, cuda_device, dtype)
    for n_q in (1, 9, 33, 64):
        q = unit_rows(n_q, d, g, cuda_device, dtype)
        k1 = stream_capture(q, c, n, 59 * 128, 1)[0]                     # [17, 59, Q]
        for w in K5_WINNERS:
            got = group_max(q, c, w)
            again = group_max(q, c, w)
            want = group_max_plain(q, c, min(w + 1, 128))
            torch.cuda.synchronize()
            assert float((got[0] - want[0][:, :w]).abs().max()) <= 1e-4, (n_q, w)
            clear = k5_lanes_clear(want, w, 1e-4)
            assert torch.equal(got[1][clear], want[1][:, :w][clear]), (n_q, w)
            assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
            if w == 1:
                assert torch.equal(got[0][:, 0], k1.reshape(-1, n_q).T)


@pytest.mark.cuda
def test_float_group_max_refuses_a_cut_that_misses_the_call(cuda_device):
    """The float K5 takes search_plan's cut whole and refuses one that leaves
    a group unscored or a range empty, a query tile it has no kernel for, or
    a shared-memory figure that is not the launch's own."""
    from kirag_tpu_torch.kernels import approx as ka

    c = torch.zeros(4096, 64, device=cuda_device)
    q = torch.zeros(8, 64, device=cuda_device)
    good = ka.search_plan(8, 1, 32, 4)
    bad = [dataclasses.replace(good, splits=good.splits - 1),
           dataclasses.replace(good, splits=good.splits + 1),
           dataclasses.replace(good, q_tile=64),
           dataclasses.replace(good, smem=good.smem + 16),
           ka.search_plan(8, 1, 32, 2)]  # a bf16 block's shared memory
    old = ka.search_plan
    try:
        for cut in bad:
            ka.search_plan = lambda *args, _cut=cut: _cut
            with pytest.raises(RuntimeError, match="group_max kernel launch failed"):
                group_max(q, c, 2)
    finally:
        ka.search_plan = old
    assert torch.equal(group_max(q, c, 2)[1], group_max_plain(q, c, 2)[1])


def covering_copy_plan(n_q, k, wpb):
    """A K7b/K8 cut of (at most) ``wpb`` warps a block, one pair a warp,
    that covers the call, every block holding a pair."""
    from kirag_tpu_torch.kernels.exact import CopyPlan

    wpb = min(wpb, n_q * k)
    return CopyPlan(wpb, -(-n_q * k // wpb))


def copy_indices(n_q, k, n_groups, dtype, layout, g, device):
    """[Q, k] group indices in [-3, n_groups + 3) (out-of-range ones give
    zeros) of ``dtype``, laid out as the kernels find them: contiguous, rows
    sliced from a wider tensor (a sort's top k), every other column, or
    column-major (capdom's positions, sorted over a permuted view)."""
    full = torch.randint(-3, n_groups + 3, (n_q, 2 * k + 1), generator=g, device=device)
    full = full.to(dtype)
    if layout == "rows":
        return full[:, :k]
    if layout == "columns":
        return full[:, ::2][:, :k]
    if layout == "transposed":
        return full[:, :k].T.contiguous().T
    return full[:, :k].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "rows", "columns", "transposed"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n_c,n_q,per,k", [(5, 7, 16, 33), (1, 1, 1, 1), (2, 3, 2, 5),
                                           (3, 4, 8, 100), (4, 256, 16, 100), (2, 9, 32, 17)])
def test_copy_kernels_bitwise_equal_plain(cuda_device, n_c, n_q, per, k, dtype, layout):
    """K7b and K8: copies, zeros for an index outside the source, for int32
    and int64 indices read where they lie; under copy_plan's cut and cuts of
    1-8 warps a block (Q x k below one block's pairs, k not a multiple of
    them, ragged last blocks), one launch a call."""
    from kirag_tpu_torch.kernels import exact as kx

    g = torch.Generator(device=cuda_device).manual_seed(12)
    src = torch.randn(n_c, n_q, per * 128, generator=g, device=cuda_device)
    idx = copy_indices(n_q, k, n_c * per, dtype, layout, g, device=cuda_device)
    want = score_gather_plain(src, idx)
    assert torch.equal(want, cap_assemble_plain(idx, src, per))
    cuts = [None] + [covering_copy_plan(n_q, k, w) for w in (1, 3, 8)]
    old = kx.copy_plan
    try:
        for cut in cuts:
            if cut is not None:
                kx.copy_plan = lambda *args, _cut=cut: _cut
            reset_launch_counts()
            assert torch.equal(score_gather(src, idx), want), cut
            assert torch.equal(cap_assemble(idx, src, per), want), cut
            counts = launch_counts()
            assert counts["score_gather"] == 1 and counts["cap_assemble"] == 1
    finally:
        kx.copy_plan = old


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_copy_kernels_are_one_device_kernel_a_call(cuda_device, dtype):
    """The profiler sees one device kernel for a score_gather call and one
    for a cap_assemble call, on row-sliced and column-major indices alike:
    they are read where they lie, not cast or copied. The count is
    chip_smoke.py's (one_copy_kernel), behind its profiler lead-in."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    g = torch.Generator(device=cuda_device).manual_seed(15)
    src = torch.randn(62, 32, 8 * 128, generator=g, device=cuda_device)
    rows = copy_indices(32, 100, 62 * 8, dtype, "rows", g, device=cuda_device)
    cols = copy_indices(32, 100, 62 * 8, dtype, "transposed", g, device=cuda_device)
    smoke.one_copy_kernel(lambda: score_gather(src, rows), "score_gather", str(dtype))
    smoke.one_copy_kernel(lambda: cap_assemble(cols, src, 8), "cap_assemble", str(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_copy_kernels_address_sources_past_2_31_floats(cuda_device, dtype):
    """A source of more than 2^31 floats (8.6 GB, left unwritten but for
    the selected groups): groups past the 2^31st float copy bitwise."""
    n_c, n_q, per, k = 131_100, 8, 16, 24
    assert n_c * n_q * per * 128 > 2 ** 31
    g = torch.Generator(device=cuda_device).manual_seed(16)
    src = torch.empty(n_c, n_q, per * 128, device=cuda_device)
    n_groups = n_c * per
    idx = torch.cat([torch.randint(n_groups - 4096, n_groups, (n_q, k - 4), generator=g,
                                   device=cuda_device),
                     torch.randint(0, 64, (n_q, 2), generator=g, device=cuda_device),
                     torch.tensor([[-1, n_groups]] * n_q, device=cuda_device)], dim=1).to(dtype)
    inside = (idx >= 0) & (idx < n_groups)
    i = torch.where(inside, idx, 0).long()
    qrow = torch.arange(n_q, device=cuda_device)[:, None].expand(-1, k)
    groups = src.view(n_c, n_q, per, 128)
    groups[(i // per)[inside], qrow[inside], (i % per)[inside]] = torch.randn(
        int(inside.sum()), 128, generator=g, device=cuda_device)
    want = score_gather_plain(src, idx)
    assert bool(want[:, : k - 4].abs().sum(-1).gt(0).all())
    assert torch.equal(score_gather(src, idx), want)
    assert torch.equal(cap_assemble(idx, src, per), want)
    del src, groups
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_copy_kernels_refuse_a_plan_that_misses_the_call(cuda_device):
    """K7b and K8 take copy_plan's cut whole and refuse one that leaves pairs
    uncopied or a block empty, or takes more warps a block than the kernel
    has."""
    from kirag_tpu_torch.kernels import exact as kx

    src = torch.zeros(4, 32, 8 * 128, device=cuda_device)
    idx = torch.zeros(32, 100, dtype=torch.int64, device=cuda_device)
    good = kx.copy_plan(32, 100)
    bad = [dataclasses.replace(good, blocks=good.blocks - 1),
           dataclasses.replace(good, blocks=good.blocks + 1),
           covering_copy_plan(32, 100, kx.COPY_WARPS_PER_BLOCK[0] + 1),
           covering_copy_plan(32, 100, 16),
           covering_copy_plan(32, 100, 32)]
    old = kx.copy_plan
    try:
        for cut in bad:
            kx.copy_plan = lambda *args, _cut=cut: _cut
            with pytest.raises(RuntimeError, match="score_gather kernel launch failed"):
                score_gather(src, idx)
            with pytest.raises(RuntimeError, match="cap_assemble kernel launch failed"):
                cap_assemble(idx, src, 8)
    finally:
        kx.copy_plan = old
    assert torch.equal(score_gather(src, idx), score_gather_plain(src, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("n_c,b,br,n_q", [(8, 8, 104, 5), (8, 3, 8, 9), (2, 4, 16, 3),
                                          (40, 8, 16, 33), (1, 16, 16, 4)])
def test_window_merge_bitwise_equal_plain(cuda_device, n_c, b, br, n_q):
    """K9 over K1's outputs on integer data (many tied keys) and on random
    data: window, keys, gids and lost bitwise the plain version's."""
    g = torch.Generator(device=cuda_device).manual_seed(13)
    chunk = 2048
    for integer in (True, False):
        if integer:
            c = torch.randint(-2, 3, (n_c * chunk, 64), generator=g, device=cuda_device).float()
            q = torch.randint(-2, 3, (n_q, 64), generator=g, device=cuda_device).float()
        else:
            c = torch.randn(n_c * chunk, 64, generator=g, device=cuda_device)
            q = torch.randn(n_q, 64, generator=g, device=cuda_device)
        _, capture, gids, capmax, resid = stream_capture(q, c, n_c * chunk - 70, chunk, b)
        total = n_c * chunk // 128
        reset_launch_counts()
        got = window_merge(gids, capmax, resid, capture, br, total)
        assert launch_counts()["window_merge"] == 1
        want = window_merge_plain(gids, capmax, resid, capture, br, total)
        for x, y in zip(got, want):
            assert torch.equal(x, y)


def k1_like(n_c, bc, n_q, groups, keys, g, device):
    """K1-shaped capdom outputs made directly: each chunk's bc distinct groups
    of its gid range with keys in descending order (the peel's), a residual at
    or below the last, random payload. ``keys``: "random", "ties" (all 1),
    "integer" (-2..2: ties across the peel's edge), "masked" (integers, a
    third of them -inf)."""
    shape = (n_c, bc, n_q)
    if keys == "random":
        v = torch.randn(shape, generator=g, device=device)
    elif keys == "ties":
        v = torch.ones(shape, device=device)
    else:
        v = torch.randint(-2, 3, shape, generator=g, device=device).float()
        if keys == "masked":
            v[torch.rand(shape, generator=g, device=device) < 0.3] = float("-inf")
    capmax = v.sort(dim=1, descending=True).values.contiguous()
    local = torch.rand(n_c, groups, n_q, generator=g, device=device).argsort(dim=1)[:, :bc]
    gids = (local + torch.arange(n_c, device=device).view(-1, 1, 1) * groups).to(torch.int32)
    drop = torch.randint(0, 2, (n_c, 1, n_q), generator=g, device=device)
    resid = (capmax[:, -1:, :] - drop).contiguous()
    capture = torch.randn(n_c, n_q, bc * 128, generator=g, device=device)
    return gids.contiguous(), capmax, resid, capture


@pytest.mark.cuda
@pytest.mark.parametrize("n_q", [8, 256])
@pytest.mark.parametrize("keys", ["random", "ties", "integer", "masked"])
@pytest.mark.parametrize("n_c,bc,segment_counts", [(1283, 8, (None, 3, 5, 32)),
                                                   (10, 8, (None, 3, 9)), (4, 40, (None,))])
def test_window_merge_segments_bitwise_equal_plain(cuda_device, n_c, bc, segment_counts, keys,
                                                   n_q):
    """K9 at the DPR corpus's geometry (C = 1283 chunks, bc = 8, br = 104),
    with empty slots left (C = 10: 80 groups for 104 slots) and at bc = 40
    (the reference's steps for every query): win, wkey, wgid and lost
    bitwise the plain version's at the plan's segment count and at counts
    that do not divide C - 1. Random and all-tied keys take the segments;
    integer keys (ties across the peel's edge) send queries to the
    reference's steps (``paths``). One launch a call."""
    g = torch.Generator(device=cuda_device).manual_seed(29)
    br, groups = 104, 128
    gids, capmax, resid, capture = k1_like(n_c, bc, n_q, groups, keys, g, cuda_device)
    total = n_c * groups
    want = window_merge_plain(gids, capmax, resid, capture, br, total)
    for segments in segment_counts:
        paths = torch.full((n_q,), -1, dtype=torch.int32, device=cuda_device)
        reset_launch_counts()
        got = window_merge(gids, capmax, resid, capture, br, total, segments=segments,
                           paths=paths)
        assert launch_counts()["window_merge"] == 1
        for part, x, y in zip(("win", "wkey", "wgid", "lost"), got, want):
            assert torch.equal(x, y), (segments, part)
        assert bool(((paths == 0) | (paths == 1)).all())
        if bc > 32:
            assert bool(paths.all())
        elif keys in ("random", "ties"):
            assert not bool(paths.any()), segments
        elif keys == "integer" and n_c > 100:
            assert bool(paths.any()), segments


@pytest.mark.cuda
def test_window_merge_refuses_a_window_that_does_not_fit(cuda_device):
    """A window of 10,000 groups does not fit the block's shared memory: the
    wrapper raises (no fallback) and launches nothing."""
    g = torch.Generator(device=cuda_device).manual_seed(30)
    gids, capmax, resid, capture = k1_like(4, 8, 2, 128, "random", g, cuda_device)
    reset_launch_counts()
    with pytest.raises(ValueError, match="shared memory"):
        window_merge(gids, capmax, resid, capture, 10000, 4 * 128)
    assert launch_counts()["window_merge"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 100, 101])
@pytest.mark.parametrize("d", [200, 1024, 1040])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_float_gather_shares_groups_bitwise(cuda_device, dtype, d, k):
    """K2 on float corpora scores each selected group once for all the
    queries that chose it: 70 queries over 256 groups, 40 of them one common
    set (tiles of 32 and 8), 20 random sets (shared by few or none), 10 with
    ids outside the corpus (-1, 256, 2**30) and repeats in a row. Bitwise
    the plain version on integer data, one launch a call; on random rows K1's
    capture of repeated queries bitwise K2's re-score of its groups."""
    g = torch.Generator(device=cuda_device).manual_seed(31)
    n, groups, n_q = 32768, 256, 70
    c = torch.randint(-2, 3, (n, d), generator=g, device=cuda_device).to(dtype)
    q = torch.randint(-2, 3, (n_q, d), generator=g, device=cuda_device).to(dtype)
    order = torch.rand(21, groups, generator=g, device=cuda_device).argsort(dim=1)[:, :k]
    gsel = torch.empty(n_q, k, dtype=torch.int64, device=cuda_device)
    gsel[:40] = order[0]
    gsel[40:60] = order[1:]
    gsel[60:] = torch.randint(-1, groups + 1, (10, k), generator=g, device=cuda_device)
    gsel[60:, 0] = 2 ** 30
    reset_launch_counts()
    cand = gather_groups(q, c, gsel)
    assert launch_counts()["gather_groups"] == 1
    assert torch.equal(cand, gather_groups_plain(q, c, gsel))
    assert not cand[60:, 0].any()
    chunk, b = 2048, 8
    cr = unit_rows(n, d, g, cuda_device, dtype)
    qr = unit_rows(n_q, d, g, cuda_device, dtype)
    qr[10:50] = qr[10]
    _, capture, gids, _, _ = stream_capture(qr, cr, n, chunk, b)
    captured = gids.permute(2, 0, 1).reshape(n_q, -1)
    assert torch.equal(gather_groups(qr, cr, captured),
                       capture.view(n // chunk, n_q, b, 128).transpose(0, 1)
                       .reshape(n_q, -1, 128))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_float_gather_over_many_windows(cuda_device, dtype):
    """660 queries x 101 slots on 128 groups: 21 windows of 32 queries, each
    group's pairs in a window scored once (tiles of up to 32), ids outside
    the corpus zeros; bitwise plain on integer data, one launch."""
    g = torch.Generator(device=cuda_device).manual_seed(37)
    n, d, n_q, k = 16384, 200, 660, 101
    c = torch.randint(-2, 3, (n, d), generator=g, device=cuda_device).to(dtype)
    q = torch.randint(-2, 3, (n_q, d), generator=g, device=cuda_device).to(dtype)
    gsel = torch.randint(-1, n // 128 + 1, (n_q, k), generator=g, device=cuda_device)
    reset_launch_counts()
    cand = gather_groups(q, c, gsel)
    assert launch_counts()["gather_groups"] == 1
    assert torch.equal(cand, gather_groups_plain(q, c, gsel))


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["float32", "int4", "pq4"])
def test_every_variant_on_the_card_equals_capdom(cuda_device, fmt):
    """Every (impl, select) through the kernels equals stream/capdom through
    the kernels, bitwise, and its own plain run; a padded batch included
    (its zero rows fail the capture checks, so the fallbacks run)."""
    from kirag_tpu_torch.ops import exact as ops_exact

    g = torch.Generator(device=cuda_device).manual_seed(14)
    n, d = 20000, 256
    c, s, quant = corpus_of(fmt, n, d, g, cuda_device)
    quant = None if quant == "none" else quant
    q = torch.zeros(8, d, device=cuda_device)
    q[:5] = torch.randint(-3, 4, (5, d), generator=g, device=cuda_device).float()
    search = dict(chunk_size=2048, valid_rows=19000, scales=s, quant=quant)
    want = exact_topk_mips(q, c, 30, select="capdom", impl="stream", **search)
    combos = [("stream", "flat"), ("stream", "hier"), ("stream", "merge"), ("single", "hier"),
              ("single_strided", "hier"), ("twopass", "flat"), ("twopass", "hier")]
    for impl, select in combos:
        got = exact_topk_mips(q, c, 30, select=select, impl=impl, **search)
        plain = exact_topk_mips(q, c, 30, select=select, impl=impl, plain=True, **search)
        for x, y, z in zip(got, want, plain):
            assert torch.equal(x, y) and torch.equal(x, z), (impl, select)
    old = ops_exact.CAPDOM_ASSEMBLY
    try:
        ops_exact.CAPDOM_ASSEMBLY = "pallas"
        reset_launch_counts()
        got = exact_topk_mips(q, c, 30, select="capdom", impl="stream", on_miss="flag",
                              **search)
        assert launch_counts()["cap_assemble"] == 1
    finally:
        ops_exact.CAPDOM_ASSEMBLY = old
    ref = exact_topk_mips(q, c, 30, select="capdom", impl="stream", on_miss="flag", **search)
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
