"""``tools/time_quantized_kernels.py`` and ``tools/time_merge_gather.py``:
each variant they time (other ring depths and occupancies, int4 in two
walks, a fuller unroll, and the wrong-on-purpose diagnostics behind
PERF.md's split of the int8/int4 sweeps' time and of K9's and K2's) still
applies to this tree's sources, each patch at exactly one place, and
changes only the files it names. The timings themselves run on the card."""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def load_tool(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


tool = load_tool("time_quantized_kernels")
merge_gather = load_tool("time_merge_gather")


@pytest.mark.parametrize("name", sorted(tool.VARIANTS))
def test_variant_applies_to_this_tree(name, tmp_path):
    check_variant(tool, name, tmp_path)


@pytest.mark.parametrize("name", sorted(merge_gather.VARIANTS))
def test_merge_gather_variant_applies_to_this_tree(name, tmp_path):
    check_variant(merge_gather, name, tmp_path)


def check_variant(tool, name, tmp_path):
    tool.make_variant(name, str(tmp_path / name))
    out = tmp_path / name / "kirag_tpu_torch"
    patched = {rel for rel, _, _ in tool.VARIANTS[name]}
    for src in sorted((ROOT / "kirag_tpu_torch").rglob("*")):
        rel = src.relative_to(ROOT)
        if not src.is_file() or "build" in rel.parts or "__pycache__" in rel.parts:
            continue
        same = (out.parent / rel).read_bytes() == src.read_bytes()
        assert same != (str(rel) in patched), rel
    for rel, old, new in tool.VARIANTS[name]:
        assert new in (out.parent / rel).read_text()
