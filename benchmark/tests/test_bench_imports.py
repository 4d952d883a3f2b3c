"""Nothing that the benchmark runs loads JAX, the JAX package or the repo's
JAX-era bench scripts; the reference loads nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import harness

BENCH = harness.BENCH
FORBIDDEN_FILES = {"tools", "bench", "chip_smoke", "chip_ab"}


def _imported(path: Path) -> set:
    """Top-level names of every module a source imports, at any depth."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_no_jax_nor_jax_era_scripts():
    for path in BENCH.rglob("*.py"):
        found = _imported(path) & (set(harness.FORBIDDEN) | FORBIDDEN_FILES)
        assert not found, f"{path.relative_to(BENCH)} imports {found}"


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        assert _imported(path) <= {"__future__", "contextlib", "functools", "numpy", "torch"}, path


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=BENCH.parent, timeout=600, check=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


PRELUDE = f"""
import json, sys
sys.path[:0] = [{str(BENCH)!r}, {str(BENCH.parent)!r}]
"""


def test_harness_run_loads_no_jax():
    """A whole small cell on the CPU, then sys.modules by whole top-level names."""
    code = PRELUDE + f"""
import time
from pathlib import Path
sys.path.insert(0, {str(BENCH / 'tests')!r})
import run, test_bench_harness as t
import tempfile
root = t.tiny_checkout(Path(tempfile.mkdtemp()))
import contextlib, io
with contextlib.redirect_stdout(io.StringIO()):
    assert run.main(["--workload", "tiny-train", "--seed", "3", "--seconds", "0.2", "--trace", "1"],
                    root=root, bench=root / "benchmark", need_cuda=False,
                    t0=time.perf_counter()) == 0
import calibrate, faults
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""
    tops = _modules_after(code)
    assert "construction_clip_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "construction_clip_tpu"}


def test_reference_loads_nothing_of_the_program():
    code = PRELUDE + """
import harness, weights
ref = harness.load_module(harness.BENCH / "reference" / "clip.py")
cfg = json.load(open(harness.BENCH / "configs" / "clip-vit-b-32.json"))
print(json.dumps(sorted({n.split(".")[0] for n in sys.modules})))
"""
    tops = _modules_after(code)
    assert not tops & {"construction_clip_tpu_torch", "construction_clip_tpu", "jax"}
