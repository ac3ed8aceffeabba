"""What the benchmark loads, checked in fresh interpreters: a whole run
loads no module whose top-level name is ``jax``, ``jaxlib``, ``flax`` or
``nrtsearch_tpu`` (names compared whole: ``nrtsearch_tpu_torch`` begins
with ``nrtsearch_tpu``), and the yardstick (reference, check, generator)
loads nothing of the program."""

import ast
import json
import subprocess
import sys

import pytest

from portbench import harness

ROOT = harness.ROOT
FORBIDDEN_FILES = {"bench", "chip_smoke", "benchmarks"}


def _fresh(code: str) -> list[str]:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin", "HOME": "/tmp"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_and_no_jax_package():
    tops = _fresh(
        "import json, sys, torch\n"
        "from portbench import harness\n"
        "from portbench.conftest import tiny_overrides\n"
        "for cell in ('node-8m.text-b32', 'batch-8m.search-b32', 'batch-8m.bucket-b32'):\n"
        "    r, _ = harness.run_cell(cell, 3, 0.2, cell.endswith('search-b32'),\n"
        "                            torch.device('cpu'), tiny_overrides(cell))\n"
        "    assert r['correct'], r\n"
        "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))\n")
    assert "nrtsearch_tpu_torch" in tops
    assert not set(tops) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("module", ["portbench.reference", "portbench.compare",
                                    "portbench.generate", "portbench.control",
                                    "portbench.kinds.bm25",
                                    "portbench.trace", "portbench.metrics.merge_roofline_pct"])
def test_the_yardstick_loads_nothing_of_the_program(module):
    tops = _fresh(f"import json, sys, {module}\n"
                  "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))\n")
    assert "nrtsearch_tpu_torch" not in tops and not set(tops) & set(harness.FORBIDDEN)


def test_no_source_imports_the_jax_side():
    for path in sorted((ROOT / "portbench").rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".", 1)[0]
                assert top not in harness.FORBIDDEN and top not in FORBIDDEN_FILES, (path, name)


def test_forbidden_names_are_compared_whole():
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "nrtsearch_tpu")
    saved = sys.modules.get("jaxlib_lookalike")
    sys.modules["jaxlib_lookalike"] = sys
    try:
        assert "jaxlib_lookalike" not in harness.forbidden_modules()
    finally:
        if saved is None:
            del sys.modules["jaxlib_lookalike"]
