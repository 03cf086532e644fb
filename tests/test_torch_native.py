"""The port's host C++ (``kirag_tpu_torch/csrc/host``) held against the JAX
package's (``native/``): the DPR TSV parser behind ``load_psg_data(native=)``
and the CPU flat index, on the same synthetic files and rows.

Both libraries are compiled from the same sources with the same flags, so
the flat indexes' scores are compared bitwise; the parsed rows must equal
the Python loaders' in both packages, quoting, punctuation, newline and
whitespace cases included. Skips only where g++ is missing, as the JAX
package's tests do.
"""

import random
import shutil

import numpy as np
import pytest

from kirag_tpu.data.corpus import load_psg_data as jax_load_psg_data
from kirag_tpu.index.native import CPUFlatIndex as JaxCPUFlatIndex
from kirag_tpu_torch.data.corpus import Wikipedia, load_psg_data
from kirag_tpu_torch.index.native import CPUFlatIndex, native_available
from kirag_tpu_torch.kernels.build import build_host, host_library_path

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ toolchain")

SAMPLE = (
    "id\ttext\ttitle\n"                                   # header: skipped
    "1\tPlain passage text.\tPlain Title\n"
    "2\t\"Quoted passage\"\t'Punct Title'\n"              # one punctuation mark off each end
    "3\tHe said \"\"hi\"\" twice \"\"ok\"\"\tT3\n"        # doubled quotes collapse
    "short\tonly-two-fields\n"                            # < 3 fields: dropped
    "4\tfield\twith\textra\ttabs\n"                       # extra fields ignored
    "5\t  spaced  \t  Title Spaced  \n"                   # the line's ends stripped only
    "6\t.\t!\n"                                           # a lone punctuation mark
    "7\t\t\n"                                             # empty text and title
    "8\t\"\"\"triple\"\"\"\t((Paren))\n"                  # quotes at the ends, then doubled
    "9\tünïcödé – text…\tÜber\n"                          # multi-byte UTF-8 inside fields
)


def random_tsv(n, seed):
    rnd = random.Random(seed)
    rows = ["id\ttext\ttitle"]
    for i in range(n):
        text = "".join(rnd.choice("abc \"'.,!xyz\t") for _ in range(40))
        title = "".join(rnd.choice("ABC\"'.d ") for _ in range(12))
        rows.append(f"{i}\t{text}\t{title}")
    return "\n".join(rows) + "\n"


CASES = {
    "sample": SAMPLE.encode(),
    "random": random_tsv(2000, 0).encode(),
    "newlines": (b"id\ttext\ttitle\n"
                 b"1\talpha\tA\r"                 # a lone \r ends a line
                 b"2\tbeta\tB\r\n"                # \r\n counts once
                 b"3\tgamma\x1c\tC\x1f\n"         # FS/US stripped as Python's strip()
                 b"4\tdelta\tD"),                 # no final newline
    "header_only": b"id\ttext\ttitle\n",
    "empty": b"",
}


@pytest.fixture(params=sorted(CASES))
def tsv_file(request, tmp_path):
    path = tmp_path / f"{request.param}.tsv"
    path.write_bytes(CASES[request.param])
    return str(path)


@pytest.mark.parametrize("native", [True, False, None])
def test_load_psg_data_matches_the_reference(tsv_file, native):
    want = jax_load_psg_data(tsv_file, native=False)
    assert list(jax_load_psg_data(tsv_file, native=True)) == want
    got = load_psg_data(tsv_file, native=native)
    assert len(got) == len(want)
    assert list(got) == want
    assert [got[i] for i in range(len(got))] == want
    if native is not False:
        assert type(got).__name__ == "TsvPassages"


def test_lazy_rows_follow_list_semantics(tmp_path):
    path = tmp_path / "sample.tsv"
    path.write_text(SAMPLE, encoding="utf-8")
    nat = load_psg_data(str(path), native=True)
    py = load_psg_data(str(path), native=False)
    assert nat[-1] == py[-1] and nat[1:4] == py[1:4] and nat[::3] == py[::3]
    with pytest.raises(IndexError):
        nat[len(py)]


def test_native_none_takes_the_python_loop_when_the_parser_fails(tmp_path, monkeypatch):
    import kirag_tpu_torch.data.native_tsv as native_tsv

    def broken(path):
        raise OSError("no parser")

    path = tmp_path / "sample.tsv"
    path.write_text(SAMPLE, encoding="utf-8")
    monkeypatch.setattr(native_tsv, "load_psg_data_native", broken)
    assert load_psg_data(str(path)) == jax_load_psg_data(str(path), native=False)
    with pytest.raises(OSError):
        load_psg_data(str(path), native=True)


def test_wikipedia_corpus_reads_through_the_parser(tmp_path):
    from kirag_tpu.data.corpus import Wikipedia as JaxWikipedia

    path = tmp_path / "sample.tsv"
    path.write_text(SAMPLE, encoding="utf-8")
    wiki, ref = Wikipedia(corpus_path=str(path)), JaxWikipedia(corpus_path=str(path))
    assert type(wiki.data).__name__ == "TsvPassages"
    for pid in ("1", "3", "8", "9"):
        assert wiki.get_document(pid) == ref.get_document(pid)
        assert wiki.doc_to_str(wiki.get_document(pid)) == ref.doc_to_str(ref.get_document(pid))


def test_host_libraries_build_once_into_the_cache():
    assert native_available()
    for name in ("tsv_corpus", "flat_index"):
        first, again = build_host(name), build_host(name)
        assert first.path == again.path == host_library_path(name) and again.path.exists()
        assert again.seconds == 0.0  # the cached library is reused
        assert again.path.parent.name == "build" and again.path.name.startswith(f"lib{name}_")


def test_index_package_exports_the_flat_index_lazily():
    import kirag_tpu_torch.index as index

    assert index.CPUFlatIndex is CPUFlatIndex
    with pytest.raises(AttributeError):
        index.NoSuchIndex


def both_indexes(metric, d, parts):
    port, ref = CPUFlatIndex(d, metric=metric), JaxCPUFlatIndex(d, metric=metric)
    start = 0
    for rows in parts:  # appends, as an index built shard by shard
        ids = [f"p{i}" for i in range(start, start + len(rows))]
        port.index_data(ids, rows)
        ref.index_data(ids, rows)
        start += len(rows)
    return port, ref


def assert_bitwise(got, want):
    assert len(got) == len(want)
    for (g_ids, g_scores), (w_ids, w_scores) in zip(got, want):
        assert g_ids == w_ids
        np.testing.assert_array_equal(g_scores, w_scores)


@pytest.mark.parametrize("metric", ["inner_product", "l2"])
@pytest.mark.parametrize("d", [8, 37, 256])
def test_flat_index_matches_the_reference(rng, metric, d):
    parts = [rng.randn(300, d).astype(np.float32), rng.randn(123, d).astype(np.float32)]
    port, ref = both_indexes(metric, d, parts)
    q = rng.randn(6, d).astype(np.float32)
    assert len(port) == len(ref) == 423
    got = port.search_knn(q, 11)
    assert_bitwise(got, ref.search_knn(q, 11))
    rows = np.concatenate(parts).astype(np.float64)
    s = q.astype(np.float64) @ rows.T
    if metric == "l2":
        s = -((q[:, None, :].astype(np.float64) - rows[None]) ** 2).sum(-1)
    top = np.argsort(-s, axis=1, kind="stable")[:, 0]
    assert [ids[0] for ids, _ in got] == [f"p{i}" for i in top]


@pytest.mark.parametrize("metric", ["inner_product", "l2"])
def test_flat_index_files_load_across_packages(rng, tmp_path, metric):
    parts = [rng.randn(200, 16).astype(np.float32)]
    port, ref = both_indexes(metric, 16, parts)
    q = rng.randn(4, 16).astype(np.float32)
    port.serialize(str(tmp_path / "port"))
    ref.serialize(str(tmp_path / "ref"))
    assert ((tmp_path / "port" / "index.flat").read_bytes()
            == (tmp_path / "ref" / "index.flat").read_bytes())
    from_ref, from_port = CPUFlatIndex(16, metric=metric), JaxCPUFlatIndex(16, metric=metric)
    from_ref.deserialize_from(str(tmp_path / "ref"))
    from_port.deserialize_from(str(tmp_path / "port"))
    want = ref.search_knn(q, 5)
    assert_bitwise(from_ref.search_knn(q, 5), want)
    assert_bitwise(from_port.search_knn(q, 5), want)
    assert_bitwise(port.search_knn(q, 5), want)


@pytest.mark.parametrize("metric", ["inner_product", "l2"])
def test_flat_index_ties_and_k_past_the_rows(metric):
    rows = np.ones((10, 4), dtype=np.float32)
    port, ref = both_indexes(metric, 4, [rows])
    q = np.ones((2, 4), dtype=np.float32)
    assert [ids for ids, _ in port.search_knn(q, 3)] == [["p0", "p1", "p2"]] * 2
    assert_bitwise(port.search_knn(q, 12), ref.search_knn(q, 12))
    assert port.search_knn(q, 12)[0][0] == [f"p{i}" for i in range(10)]
    assert_bitwise(port.search_knn(q[0], 3), ref.search_knn(q[0], 3))


def test_flat_index_agrees_with_the_torch_indexer(rng):
    from kirag_tpu_torch.index import TorchIndexer

    rows = rng.randn(500, 32).astype(np.float32)
    q = rows[:5] + 0.1 * rng.randn(5, 32).astype(np.float32)
    flat = CPUFlatIndex(32)
    flat.index_data(range(500), rows)
    torch_index = TorchIndexer(32, device="cpu")
    torch_index.index_data(range(500), rows)
    for (f_ids, f_scores), (t_ids, t_scores) in zip(flat.search_knn(q, 8),
                                                     torch_index.search_knn(q, 8)):
        assert f_ids == t_ids
        np.testing.assert_allclose(f_scores, t_scores, rtol=1e-5, atol=1e-5)


def test_flat_index_checks_its_inputs(rng):
    with pytest.raises(KeyError):
        CPUFlatIndex(8, metric="cosine")
    index = CPUFlatIndex(8)
    with pytest.raises(ValueError):
        index.index_data(range(3), rng.randn(3, 9).astype(np.float32))
    with pytest.raises(ValueError):
        index.index_data(range(2), rng.randn(3, 8).astype(np.float32))
