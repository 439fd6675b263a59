"""The import check: no run loads JAX or the JAX package (top-level
names compared whole), the reference loads nothing of the program, and
the harness reads none of the repository's older bench scripts."""

import ast
import json
import os
import subprocess
import sys
import types

import pytest

from benchmark.harness import env, spec

BENCH_DIR = spec.BENCH_DIR


@pytest.mark.parametrize("name,flagged", [
    ("flappie_tpu", True), ("flappie_tpu.ops.crf", True), ("jax", True), ("jax.numpy", True),
    ("jaxlib.xla_client", True), ("flax", True), ("flappie_tpu_torch", False),
    ("flappie_tpu_torch.basecall", False), ("jaxtyping", False), ("flaxen", False),
])
def test_forbidden_names_compare_whole(monkeypatch, name, flagged):
    for m in [m for m in sys.modules if m.split(".")[0] in env.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (env.forbidden_loaded() != []) == flagged


def _sources():
    for base, _dirs, files in os.walk(BENCH_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in env.FORBIDDEN, f"{path} imports {n}"


def test_no_source_reads_the_old_bench_scripts():
    for path in _sources():
        if os.sep + "tests" + os.sep in path:
            continue
        text = open(path).read()
        for old in ("bench_common", "bench_scaling", "bench.py\"", "BENCH_r0", "MULTICHIP_r0"):
            assert old not in text, f"{path} names {old}"


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference.flipflop, "
            "benchmark.reference.signal; print(sorted({m.split('.')[0] for m in sys.modules}))"
            % spec.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"flappie_tpu_torch", "flappie_tpu", "jax", "jaxlib", "flax"}


def test_reference_sources_import_nothing_of_the_program():
    ref = os.path.join(BENCH_DIR, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            tree = ast.parse(open(os.path.join(ref, f)).read())
            for node in ast.walk(tree):
                if isinstance(node, ast.ImportFrom) and node.level == 0:
                    assert not node.module.startswith("flappie_tpu"), f
                if isinstance(node, ast.Import):
                    assert not any(a.name.startswith("flappie_tpu") for a in node.names), f


def test_run_without_a_card_prints_no_result():
    """run.py on a host without CUDA: a non-zero exit and no result."""
    code = ("import sys, torch; torch.cuda.is_available = lambda: False; sys.argv = "
            "['run.py', '--workload', 'r941_native.offline', '--seed', '1', '--seconds', '1']; "
            "sys.path.insert(0, %r); import runpy; runpy.run_path(%r, run_name='__main__')"
            % (spec.ROOT, os.path.join(BENCH_DIR, "run.py")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "cuda" in out.stderr.lower()


def test_run_outside_a_checkout_fails(tmp_path):
    """A directory with only BENCHMARK.json and benchmark/: the program is
    missing, so the run exits non-zero with no result."""
    import shutil

    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "r941_native.offline",
                          "--seed", "1", "--seconds", "1"], cwd=tmp_path, capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == "" or not out.stdout.strip().splitlines()[-1].startswith("{")
    json.dumps(out.stderr[-200:])
