"""What a cell loads: nothing of JAX or the JAX package, and a reference
that imports nothing of the program."""

import ast
import json
import subprocess
import sys

from port_bench.bench.cell import BENCH_DIR
from port_bench.bench.device import FORBIDDEN, forbidden_modules


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_forbidden_names_compare_whole_top_level_names():
    assert forbidden_modules({"jax.numpy": 1, "numpy": 1}) == ["jax.numpy"]
    assert forbidden_modules({"mamba_unet_torch.ops": 1, "jaxtyping": 1,
                              "mamba_unet_tpu": 1}) == ["mamba_unet_tpu"]


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH_DIR / "reference").glob("*.py")):
        for name in _imports(path):
            top = name.split(".", 1)[0]
            assert top != "mamba_unet_torch", (path, name)
            assert top not in FORBIDDEN, (path, name)


def test_no_benchmark_file_imports_jax():
    for path in sorted(BENCH_DIR.rglob("*.py")):
        for name in _imports(path):
            assert name.split(".", 1)[0] not in FORBIDDEN, (path, name)


def test_a_cells_import_tree_holds_no_jax(tiny_root):
    """A whole tiny run in a fresh process, then its ``sys.modules``."""
    code = (
        "import sys, time, json\n"
        f"sys.path.insert(0, {str(BENCH_DIR.parent)!r})\n"
        "from pathlib import Path\n"
        "import torch; torch.set_num_threads(2)\n"
        "from port_bench.bench.cell import resolve\n"
        "from port_bench.bench.runner import execute\n"
        f"root = Path({str(tiny_root)!r})\n"
        "cell = resolve(root, 'tiny.sup', root / 'port_bench')\n"
        "code, res = execute(cell, 7, 0.2, True, 'cpu', time.perf_counter())\n"
        "assert code == 0 and res['correct']\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "mamba_unet_torch" in {m.split(".")[0] for m in loaded}
    assert forbidden_modules(loaded) == []

