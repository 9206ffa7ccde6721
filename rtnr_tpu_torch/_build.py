"""Build and load the hand-written CUDA kernels (``csrc/*.cu``) and the
host library (``csrc/host/*.cpp``).

Each source compiles with ``nvcc`` into its own shared library with a plain
C interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds). Libraries go to ``rtnr_tpu_torch/_build/`` (git-ignored), named by
a hash of the source, the shared headers (``csrc/*.cuh``) and the flags, so
an edited source or header rebuilds and an unchanged one is reused.
``build_all`` starts one ``nvcc`` per source at once and waits for all of
them.

Nothing here runs at import time: the first launch on a CUDA tensor calls
``load``. Every build passes ``-Xptxas -v``; ``build_all`` returns the
compiler's per-kernel register / shared-memory / spill report
(``ptxas_report``).

The host library (the E57 container decoder and the JPEG codec) is one
``g++`` build of every ``csrc/host/*.cpp`` into the same
directory, named by a hash of those sources and the flags; ``load_host``
builds it at first use and raises with the compiler's output if it fails.
Several processes may build it at once: each compiles to a file of its own
and moves it in place with ``os.replace``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Tuple

SRC_DIR = Path(__file__).resolve().parent / "csrc"
HOST_DIR = SRC_DIR / "host"
OUT_DIR = Path(__file__).resolve().parent / "_build"

# library name -> (source file, extra nvcc flags)
SOURCES: Dict[str, tuple] = {
    # -fmad=false: the resolve must be bit-identical to its plain twin
    "raster_resolve": ("raster_resolve.cu", ["-fmad=false"]),
    "conv": ("conv.cu", []),
    # TMA + wgmma; cuTensorMapEncodeTiled comes through the CUDA runtime's
    # entry-point query (see the source's header), so no -lcuda
    "conv_sm90": ("conv_sm90.cu", []),
    # the int8 modes of K3 (dyn) and K4 (static) on s8 wgmma and TMA
    "conv_i8_sm90": ("conv_i8_sm90.cu", []),
    # the U-Net's input conv (1-8 channels -> 64) on mma.sync, bf16 or int8 out
    "conv_in_sm90": ("conv_in_sm90.cu", []),
    # UNetTrain's BatchNorm + ReLU, forward and backward
    "bn_train": ("bn_train.cu", []),
    # the depth prefilter of a full frame; -fmad=false: bit-identical to the plain path
    "prefilter": ("prefilter.cu", ["-fmad=false"]),
}

_BASE_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# the host library's g++ flags (one shared object, C ABI)
HOST_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _flags(name: str):
    return _BASE_FLAGS + SOURCES[name][1]


def _target(name: str) -> Path:
    src = SRC_DIR / SOURCES[name][0]
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return OUT_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Tuple[float, str]]:
    """Compile every missing library in parallel; returns (seconds, nvcc's
    output) per name ((0.0, "") for one already built). Raises with nvcc's
    output on failure."""
    names = list(SOURCES if names is None else names)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    built = {}
    for name in names:
        out = _target(name)
        if out.exists():
            built[name] = (0.0, "")
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path()] + _flags(name) + ["-o", str(tmp), str(SRC_DIR / SOURCES[name][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    errors = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        built[name] = (time.perf_counter() - t0, log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name} (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return built


def ptxas_report(log: str) -> List[str]:
    """One line per kernel from nvcc's ``-Xptxas -v`` output: its (mangled)
    name, then registers, shared memory and spills."""
    lines, name, spill = [], None, ""
    for raw in log.splitlines():
        text = raw.strip()
        m = re.search(r"entry function '([^']+)'", text)
        if m:
            name, spill = m.group(1), ""
        elif "spill stores" in text:
            spill = text
        elif name and text.startswith("ptxas info") and "Used" in text:
            lines.append(f"{name}: {text.split(':', 1)[1].strip()}; {spill}")
            name = None
    return lines


def load(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed); ``bind`` sets
    its functions' argtypes once."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        bind(lib)
        _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (its ``cudaGetLastError``)."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: cudaError {rc}")


def _host_sources() -> List[Path]:
    return sorted(HOST_DIR.glob("*.cpp"))


def host_target() -> Path:
    h = hashlib.sha256()
    for src in _host_sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(HOST_FLAGS).encode())
    return OUT_DIR / f"librtnr_host_{h.hexdigest()[:16]}.so"


def build_host() -> Tuple[float, str]:
    """Compile the host library if it is missing; returns (seconds, g++'s
    output) ((0.0, "") if already built). Raises with the output on failure."""
    out = host_target()
    if out.exists():
        return 0.0, ""
    gxx = shutil.which("g++") or shutil.which("c++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host library (csrc/host) needs a C++ compiler")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [gxx] + HOST_FLAGS + ["-o", str(tmp)] + [str(s) for s in _host_sources()]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for the host library (rc {r.returncode}):\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    return time.perf_counter() - t0, r.stdout + r.stderr


def load_host(bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded host library (built first if needed); ``bind`` sets its
    functions' argtypes once."""
    lib = _LIBS.get("host")
    if lib is None:
        build_host()
        lib = ctypes.CDLL(str(host_target()))
        bind(lib)
        _LIBS["host"] = lib
    return lib
