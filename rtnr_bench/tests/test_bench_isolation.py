"""What a run loads: never JAX or the JAX package, and the reference
nothing of the program. Top-level names are compared whole, since the
port's name begins with the JAX package's."""

import ast
import subprocess
import sys
from pathlib import Path

from rtnr_bench.tests.conftest import ROOT

BENCH = ROOT / "rtnr_bench"
JAX = {"jax", "jaxlib", "flax", "rtnr_tpu"}


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not top_level_imports(path) & JAX, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "rtnr_tpu_torch" not in top_level_imports(path), path
        assert not top_level_imports(path) & JAX, path


def loaded_after(code: str):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tiny_root):
    code = (f"from rtnr_bench import harness\n"
            f"harness.execute(['--workload', 'building50m-int8-1080p.walk', '--seed', '3', "
            f"'--seconds', '0.3', '--trace', '1'], root={str(tiny_root)!r}, device='cpu')\n"
            f"harness.execute(['--workload', 'room5m-train-1080p.steps', '--seed', '3', "
            f"'--seconds', '0.3'], root={str(tiny_root)!r}, device='cpu')\n"
            f"import rtnr_bench.run, rtnr_bench.calibrate")
    mods = loaded_after(code)
    assert "rtnr_tpu_torch" in mods and not mods & JAX


def test_the_reference_loads_nothing_of_the_program():
    mods = loaded_after("import rtnr_bench.reference.render, rtnr_bench.reference.unet, "
                        "rtnr_bench.reference.train")
    assert not mods & (JAX | {"rtnr_tpu_torch"})
