"""The port stands alone: every ``kirag_tpu_torch`` module imports with JAX,
transformers, safetensors, ml_dtypes and the JAX package itself unavailable (the GPU
machine has none of them), and no source of the port imports JAX."""

import pathlib
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_every_module_imports_without_jax():
    script = textwrap.dedent("""
        import importlib, pkgutil, sys
        for name in ("jax", "jaxlib", "transformers", "safetensors", "ml_dtypes",
                     "kirag_tpu"):
            sys.modules[name] = None  # any import of them raises ImportError
        import kirag_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(kirag_tpu_torch.__path__,
                                                       "kirag_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "kirag_tpu")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
        print(" ".join(names))
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 50
    assert {"kirag_tpu_torch.kernels.qmm", "kirag_tpu_torch.models.llm",
            "kirag_tpu_torch.generation.interface", "kirag_tpu_torch.generation.chat",
            "kirag_tpu_torch.generation.stub", "kirag_tpu_torch.evaluation.metrics",
            "kirag_tpu_torch.kg.kg_generator", "kirag_tpu_torch.kg.triples",
            "kirag_tpu_torch.prompts.kg_construction", "kirag_tpu_torch.prompts.kg_selection",
            "kirag_tpu_torch.pipeline.kirag", "kirag_tpu_torch.cli.retrieve",
            "kirag_tpu_torch.training.trainer", "kirag_tpu_torch.training.aligner",
            "kirag_tpu_torch.training.loader", "kirag_tpu_torch.data.datasets",
            "kirag_tpu_torch.utils.seeding", "kirag_tpu_torch.cli.train_aligner",
            "kirag_tpu_torch.ops.pq", "kirag_tpu_torch.generation.answer",
            "kirag_tpu_torch.pipeline.selector", "kirag_tpu_torch.cli.qa_eval",
            "kirag_tpu_torch.cli.construct_kg_corpus", "kirag_tpu_torch.data.native_tsv",
            "kirag_tpu_torch.index.native", "kirag_tpu_torch.models.registry",
            "kirag_tpu_torch.models.t5", "kirag_tpu_torch.utils.tracing",
            "kirag_tpu_torch.utils.wandb_tracker", "kirag_tpu_torch.preprocessing",
            "kirag_tpu_torch.preprocessing.odqa", "kirag_tpu_torch.parallel",
            "kirag_tpu_torch.parallel.mesh", "kirag_tpu_torch.parallel.dryrun"} <= names


def test_no_source_imports_jax():
    offenders = []
    for path in sorted((ROOT / "kirag_tpu_torch").rglob("*.py")):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1 and (
                    words[1].split(".")[0] in ("jax", "jaxlib", "kirag_tpu")):
                offenders.append(f"{path.relative_to(ROOT)}: {line.strip()}")
    assert not offenders, offenders
    chip_smoke = (ROOT / "chip_smoke.py").read_text()
    assert "import jax" not in chip_smoke and "kirag_tpu." not in chip_smoke.replace(
        "kirag_tpu_torch.", "")
