"""The port (rtnr_tpu_torch) and chip_smoke.py stand alone: they import with
JAX, the JAX package, msgpack and Pillow blocked, no source of theirs
imports any of them, and no source under rtnr_tpu_torch/ names the JAX
package's C++ (cpp/) or data modules."""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "rtnr_tpu_torch"

_BLOCKED_IMPORT = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "rtnr_tpu", "msgpack", "PIL"):
    sys.modules[name] = None  # any import of these now raises ImportError
import rtnr_tpu_torch
mods = ["rtnr_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(rtnr_tpu_torch.__path__, "rtnr_tpu_torch.")
]
for m in mods:
    importlib.import_module(m)
import chip_smoke
assert callable(chip_smoke.main)
parallel = {"rtnr_tpu_torch.parallel." + m
            for m in ("mesh", "collectives", "launch", "render", "tiles", "diff")}
assert parallel <= set(mods), parallel - set(mods)
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "rtnr_tpu" or m.startswith("rtnr_tpu.") or m == "msgpack" or m == "PIL"]
assert all(sys.modules[m] is None for m in bad), bad
print("imported", len(mods))
"""


def test_port_imports_with_jax_blocked():
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stderr
    n = int(res.stdout.split()[-1])
    assert n >= 48  # every module of the port was imported, parallel/ included
    # importing chip_smoke must not run it
    assert "card:" not in res.stdout


_IMPORT_RE = re.compile(
    r"^\s*(import\s+(jax|flax|msgpack|PIL)\b|from\s+(jax|flax|msgpack|PIL)\b"
    r"|import\s+rtnr_tpu(\.|\s|$)|from\s+rtnr_tpu(\.|\s))",
    re.MULTILINE,
)


def test_port_sources_never_import_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 49
    assert {"mesh.py", "collectives.py", "launch.py", "render.py", "tiles.py", "diff.py"} <= {
        f.name for f in files if f.parent.name == "parallel"}
    offenders = [
        f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
        for f in files for m in _IMPORT_RE.finditer(f.read_text())
    ]
    assert not offenders, offenders


def test_port_sources_never_name_the_jax_package_native_code():
    """The port builds its host library from its own csrc/host sources: no
    source under rtnr_tpu_torch/ names the JAX package's cpp/ directory or
    its data modules."""
    files = [f for f in sorted(PORT.rglob("*"))
             if f.suffix in (".py", ".cpp", ".cu", ".cuh") and "_build" not in f.parts]
    assert len(files) >= 56
    offenders = [f"{f.relative_to(ROOT)}: {word}" for f in files
                 for word in ("cpp/", "rtnr_tpu/data") if word in f.read_text()]
    assert not offenders, offenders
