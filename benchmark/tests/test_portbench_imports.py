"""No module of the benchmark imports JAX or the JAX package, the reference
imports nothing of the program, and a run without a card prints no result."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import run

BENCH_DIR = run.HERE
FORBIDDEN = {"jax", "jaxlib", "flax", "ptbxl_tpu"}


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(BENCH_DIR.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert not _top_level_imports(path) & {"ptbxl_torch", "benchmark"}


def test_no_card_no_result():
    r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "ecgcnn.bulk",
                        "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
                       cwd=run.ROOT, capture_output=True, text=True, timeout=300,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "no result" in r.stderr


def test_a_checkout_without_the_program_gives_no_result(tmp_path):
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "ecgcnn.bulk",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_a_run_loads_no_jax():
    code = ("import sys; from benchmark import run, drive, control; "
            "import benchmark.kinds.closed, benchmark.kinds.train; "
            "import benchmark.metrics.kernel_roofline; "
            "print(json.dumps(run.forbidden_modules()))")
    r = subprocess.run([sys.executable, "-c", "import json; " + code], cwd=run.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []
