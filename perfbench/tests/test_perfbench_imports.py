"""No module under ``perfbench/`` imports JAX or the JAX package (the
top-level name compared whole: the port, ``repro_torch``, begins with
``repro``), the references import nothing of the program, and a run that
cannot reach a card or the port prints no result."""
from __future__ import annotations

import ast
import pathlib
import shutil
import subprocess
import sys

from harness import common

BENCH = pathlib.Path(__file__).resolve().parents[1]


def _imports(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        assert not _imports(f) & set(common.FORBIDDEN), f


def test_forbidden_names_are_compared_whole():
    assert common.forbidden_modules(["repro_torch", "repro_torch.models", "jaxtyping"]) == []
    assert common.forbidden_modules(["repro.core", "jax", "flax.linen", "torch"]) == [
        "flax.linen", "jax", "repro.core"]


def test_the_references_import_nothing_of_the_program():
    for f in (BENCH / "reference").glob("*.py"):
        assert _imports(f) <= {"__future__", "contextlib", "torch"}, f


def test_a_run_without_a_card_prints_no_result():
    if _has_card():
        return  # on the card the run goes ahead; the check is for machines without one
    run = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "mistral-nemo-12b.kv-park", "--seed", "1", "--seconds", "1"],
                         cwd=common.ROOT, capture_output=True, text=True, timeout=300)
    assert run.returncode != 0 and run.stdout.strip() == ""


def test_a_checkout_of_only_the_benchmark_prints_no_result(tmp_path):
    shutil.copy(common.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    run = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "mistral-nemo-12b.kv-park", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert run.returncode != 0 and run.stdout.strip() == ""
    assert "src/repro_torch" in run.stderr


def _has_card() -> bool:
    import torch

    return torch.cuda.is_available()
