"""Nothing the benchmark runs imports JAX or the JAX package, judged by
each module's whole top-level name (the port's name begins with the JAX
package's), and the reference imports nothing of the port."""

from __future__ import annotations

import ast
import pathlib
import subprocess
import sys

from benchmark.harness import FORBIDDEN
from benchmark.spec import PACKAGE_DIR, REPO_DIR

PORT = "epipolarpose_tpu_torch"


def _imports(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    sources = sorted(PACKAGE_DIR.rglob("*.py"))
    assert len(sources) > 20
    for path in sources:
        bad = _imports(path) & set(FORBIDDEN)
        assert not bad, f"{path} imports {bad}"


def test_reference_imports_nothing_of_the_port():
    for path in sorted((PACKAGE_DIR / "reference").rglob("*.py")):
        assert PORT not in _imports(path), path


def test_whole_names_tell_the_port_from_the_jax_package():
    assert PORT.startswith("epipolarpose_tpu")
    assert PORT.split(".")[0] not in FORBIDDEN


def test_a_cpu_run_loads_no_jax():
    code = ("import tempfile, pathlib\n"
            "from benchmark import harness\n"
            "from benchmark.tests import portbench_tiny as tiny\n"
            "with tempfile.TemporaryDirectory() as d:\n"
            "    spec = tiny.write(pathlib.Path(d))\n"
            "    result, _ = tiny.run(spec, 'tiny_eval', seconds=0.3)\n"
            "assert result['correct']\n"
            "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_DIR,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
