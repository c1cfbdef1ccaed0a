"""What the benchmark loads: no JAX and no JAX package in the harness's
process, and a reference that imports nothing of the program; and the run
script's refusals."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import tiny  # noqa: F401
import common

BENCH = common.BENCH
ROOT = common.ROOT


def _py_files(d: Path):
    return sorted(p for p in d.rglob("*.py") if "tests" not in p.parts)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_harness_loads_no_jax():
    """Every module of the harness and the port's modules a run loads,
    imported in a fresh process: no module whose top-level name is
    forbidden."""
    mods = [".".join(p.relative_to(BENCH).with_suffix("").parts) for p in _py_files(BENCH)]
    code = (
        "import importlib, json, sys\n"
        f"sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import program\n"
        "program.named_shapes(json.load(open(sys.argv[1])))\n"
        "import ml_mdm_tpu_torch.trainer, ml_mdm_tpu_torch.diffusion\n"
        "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))\n")
    cfg = ROOT / "benchmark" / "configs" / "cc12m_1024x1024.json"
    out = subprocess.run([sys.executable, "-c", code, str(cfg)], capture_output=True,
                         text=True, check=True, cwd=ROOT, env=dict(os.environ, USE_FLAX="0"))
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "ml_mdm_tpu_torch" in top
    assert not top & set(common.FORBIDDEN)


def test_loaded_forbidden_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ml_mdm_tpu_torch_fake", sys)
    assert "ml_mdm_tpu" not in common.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "ml_mdm_tpu.core", sys)
    assert common.loaded_forbidden() == ["ml_mdm_tpu"]


def test_reference_imports_nothing_of_the_program():
    for path in _py_files(BENCH / "reference") + _py_files(BENCH / "flops"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("ml_mdm_tpu_torch",) + common.FORBIDDEN, (path, name)


def test_harness_reads_no_root_script():
    """Neither imported nor named as a path: root ``bench.py`` and
    ``chip_smoke.py`` (docstrings may cite where arithmetic was copied
    from)."""
    for path in _py_files(BENCH):
        assert not {n.split(".")[0] for n in _imports(path)} & {"bench", "chip_smoke"}
        tree = ast.parse(path.read_text())
        literals = [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
                    and isinstance(n.value, str) and "\n" not in n.value]
        assert not [s for s in literals if s.endswith(("bench.py", "chip_smoke.py"))], path


def _run(cwd: Path):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "sample64_b32_cfg",
                           "--seed", "3000000011", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=cwd, timeout=300)


def test_run_exits_nonzero_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the refusal is not reachable here")
    out = _run(ROOT)
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA device" in out.stderr


def test_run_exits_nonzero_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
