"""Nothing the benchmark runs may import JAX or the JAX package, and the
reference imports nothing of the program: a scan of every import of the
benchmark's files by whole top-level name, and a run in a fresh process."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
JAX_NAMES = {"jax", "jaxlib", "flax", "stereo_depth_ruler_tpu"}
PROGRAM = "stereo_depth_ruler_tpu_torch"


def top_level_imports(path: Path) -> set:
    """The top-level names (the part before the first dot, whole) of every
    absolute import in a file."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def runtime_files():
    return [p for p in sorted(BENCH.rglob("*.py")) if "tests" not in p.parts]


def test_top_level_names_are_compared_whole(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import stereo_depth_ruler_tpu_torch.pipeline\n"
                 "from stereo_depth_ruler_tpu_torch.ops import wls\n")
    assert not top_level_imports(f) & JAX_NAMES
    f.write_text("from stereo_depth_ruler_tpu.ops import sgbm\n")
    assert top_level_imports(f) & JAX_NAMES == {"stereo_depth_ruler_tpu"}
    f.write_text("import jax.numpy as jnp\n")
    assert top_level_imports(f) & JAX_NAMES == {"jax"}


@pytest.mark.parametrize("path", runtime_files(),
                         ids=lambda p: p.relative_to(BENCH).as_posix())
def test_no_jax_import(path):
    assert not top_level_imports(path) & JAX_NAMES


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert PROGRAM not in names and not names & JAX_NAMES
    if path.name != "__init__.py":
        assert path.read_text().startswith("# Frozen copy of ")


def test_a_run_loads_no_jax(tmp_path):
    """A whole tiny run on the CPU in a fresh process; then sys.modules
    holds no JAX name, by run.py's own check."""
    code = f"""
import sys, time, json
sys.path[:0] = [{str(BENCH.parent)!r}, {str(BENCH)!r}, {str(BENCH / 'tests')!r}]
import run
from conftest import tiny
from harness import cell
r = cell.run(tiny("hd720_d128_full.batch8"), 5, 0.3, False, "cpu",
             time.perf_counter(), lambda m: None)
print(json.dumps({{"bad": run.loaded_forbidden(), "correct": r["correct"]}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"bad": [], "correct": True}


def test_run_refuses_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    folder, a run exits non-zero and prints no result."""
    import shutil
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "hd720_d128_full.batch8", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
