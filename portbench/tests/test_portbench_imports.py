"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port: checked on the import statements
of every source file and on ``sys.modules`` of a process that loaded them,
by whole top-level module name (the port's name begins with the JAX
package's)."""
from __future__ import annotations

import ast
import subprocess
import sys

from conftest import BENCH_DIR, CHECKOUT

import run

JAX = {"jax", "jaxlib", "flax", "custom_diffusion360_tpu"}
PORT = "custom_diffusion360_torch"


def _imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_source_imports_jax():
    for path in BENCH_DIR.rglob("*.py"):
        assert not JAX & set(_imported(path)), path


def test_the_reference_imports_nothing_of_the_port():
    for path in (BENCH_DIR / "refmodel").rglob("*.py"):
        assert PORT not in set(_imported(path)), path


def test_loaded_modules_by_whole_name():
    code = ("import sys; sys.path[:0] = [{!r}, {!r}]; import run; run.environment(); "
            "from harness import models; models.package(models.REFERENCE); "
            "assert not any(m.split('.')[0] == 'custom_diffusion360_torch' for m in sys.modules); "
            "models.package(models.PORT); import calibrate; "
            "from harness import cell; "
            "print(sorted({{m.split('.')[0] for m in sys.modules}}))").format(
                str(CHECKOUT), str(BENCH_DIR))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=CHECKOUT)
    assert out.returncode == 0, out.stderr
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert PORT in loaded and not loaded & JAX


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    monkeypatch.setitem(sys.modules, "custom_diffusion360_tpu_extra", sys)
    assert not set(run.forbidden_modules()) & {"jaxtyping_like", "custom_diffusion360_tpu"}
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax"]
