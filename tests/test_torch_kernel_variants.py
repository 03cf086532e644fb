"""``tools/time_quantized_kernels.py``: each variant it times (other ring
depths and occupancies, int4 in two walks, a fuller unroll, and the
wrong-on-purpose diagnostics behind PERF.md's split of the int8/int4 sweeps'
time) still applies to this tree's sources, each patch at exactly one place,
and changes only the files it names. The timings themselves run on the card."""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "time_quantized_kernels", ROOT / "tools" / "time_quantized_kernels.py")
tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tool)


@pytest.mark.parametrize("name", sorted(tool.VARIANTS))
def test_variant_applies_to_this_tree(name, tmp_path):
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
