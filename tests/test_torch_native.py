"""The port's host library (``rtnr_tpu_torch/csrc/host``, bound in
``rtnr_tpu_torch.data.native``) builds from the port's own sources into the
git-ignored ``_build/`` (several processes at once, safely), and a failed
build raises with the compiler's output. The port reads PLY and ``.oct`` in
numpy alone: binary PLYs read the same as the JAX package's native reader
and its numpy reader, ascii PLYs the same as its numpy reader (its native
reader declines them), and ``.oct`` files are the same bytes as its native
``write_oct`` and read back as its native ``read_oct`` does."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from rtnr_tpu.data import native as jnative
from rtnr_tpu.data.ply import _read_ply_py as jax_read_ply_py
from rtnr_tpu.scene import Scene as JScene
from rtnr_tpu_torch import _build
from rtnr_tpu_torch.data import native, oct as npoct
from rtnr_tpu_torch.data.ply import read_ply, write_ply
from rtnr_tpu_torch.scene import Scene

ROOT = Path(__file__).resolve().parents[1]


def test_host_library_builds_from_the_port_sources():
    lib = native.load()
    srcs = _build._host_sources()
    assert [s.name for s in srcs] == ["rtnr_e57.cpp", "rtnr_jpeg.cpp"]
    assert all(s.parent == ROOT / "rtnr_tpu_torch" / "csrc" / "host" for s in srcs)
    target = _build.host_target()
    assert target.parent == ROOT / "rtnr_tpu_torch" / "_build" and target.exists()
    assert lib is native.load()  # loaded once
    for fn in ("e57_open", "e57_read_field_f64", "e57_read_blob", "jpeg_decode",
               "jpeg_encode"):
        assert hasattr(lib, fn)


_BUILD_INTO = """
import sys
from pathlib import Path
from rtnr_tpu_torch import _build
_build.OUT_DIR = Path(sys.argv[1])
secs, _ = _build.build_host()
print(_build.host_target().name)
"""


def test_concurrent_builds_into_one_directory(tmp_path):
    """Two processes building at once (as xdist workers do) both finish with
    one complete library and no stray temporary file."""
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_INTO, str(tmp_path)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    names = {o[0].strip() for o in outs}
    assert names == {_build.host_target().name}
    assert sorted(f.name for f in tmp_path.iterdir()) == sorted(names)


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    (src / "broken.cpp").write_text("int f() { return undeclared_name; }\n")
    monkeypatch.setattr(_build, "HOST_DIR", src)
    monkeypatch.setattr(_build, "OUT_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="undeclared_name"):
        _build.build_host()
    assert not any((tmp_path / "out").glob("*"))


def _ply_bytes(n, seed, extra, colour, fmt="binary_little_endian"):
    rng = np.random.default_rng(seed)
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if extra:
        fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
    if colour:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    if extra:
        fields += [("intensity", "<f4"), ("ring", "<u2")]
    rec = np.zeros(n, np.dtype(fields))
    for name, code in fields:
        rec[name] = (rng.integers(0, 256, n) if code in ("u1", "<u2")
                     else rng.uniform(-50, 50, n)).astype(code)
    kinds = {"<f4": "float", "u1": "uchar", "<u2": "ushort"}
    header = ["ply", f"format {fmt} 1.0", "comment made by a test", f"element vertex {n}"]
    header += [f"property {kinds[c]} {name}" for name, c in fields]
    header += ["element face 0", "property list uchar int vertex_indices", "end_header"]
    return ("\n".join(header) + "\n").encode() + rec.tobytes(), rec


@pytest.mark.parametrize("extra", [False, True])
@pytest.mark.parametrize("colour", [False, True])
def test_read_ply_equals_jax_native_and_numpy(tmp_path, extra, colour):
    data, rec = _ply_bytes(3001, seed=int(extra) * 2 + int(colour), extra=extra, colour=colour)
    f = tmp_path / "c.ply"
    f.write_bytes(data)
    got = read_ply(f)
    want_native = jnative.read_ply_native(f)
    assert want_native is not None
    for want in (want_native, jax_read_ply_py(f)):
        np.testing.assert_array_equal(got[0], want[0])
        if colour:
            np.testing.assert_array_equal(got[1], want[1])
        else:
            assert got[1] is None and want[1] is None
    np.testing.assert_array_equal(got[0][:, 0], rec["x"])


def test_ascii_ply_reads_as_jax(tmp_path):
    rng = np.random.default_rng(3)
    pts = rng.uniform(-5, 5, (200, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (200, 3), dtype=np.uint8)
    f = tmp_path / "a.ply"
    write_ply(f, pts, cols, binary=False)
    assert jnative.read_ply_native(f) is None  # JAX leaves it to its numpy reader
    p, c = read_ply(f)
    jp, jc = jax_read_ply_py(f)
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(c, cols)
    np.testing.assert_allclose(p, pts, rtol=1e-6)


def test_oct_bytes_equal_jax_and_numpy_codec(tmp_path):
    pts = np.random.default_rng(4).uniform(-3, 3, (20_000, 3)).astype(np.float32)
    cols = np.random.default_rng(5).integers(0, 256, (20_000, 3), dtype=np.uint8)
    files = {k: tmp_path / f"{k}.oct" for k in ("jax", "numpy")}
    assert jnative.write_oct(files["jax"], JScene.from_arrays(pts, cols))
    npoct.write_oct(files["numpy"], Scene.from_arrays(pts, cols))
    assert files["jax"].read_bytes() == files["numpy"].read_bytes()
    got = npoct.read_oct(files["jax"])
    want_jax = jnative.read_oct(files["jax"])
    for g, j in zip(got, want_jax):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(j))
