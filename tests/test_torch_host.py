"""The port's host layer against the JAX package's: camera calibration files
and trajectories (tests/test_camera.py's fixtures), the scene grid, cache,
downsampling and room cloud (tests/test_scene.py), PLY (tests/test_data_io.py),
the reference's .oct cache (the JAX package's native writer) and PNG
(tests/test_cli.py). Each port function gives the JAX function's arrays and
writes its bytes, and each package reads the other's files."""

import numpy as np
import pytest

from rtnr_tpu import camera as jcam
from rtnr_tpu.data import native
from rtnr_tpu.data.ply import _read_ply_py as j_read_ply
from rtnr_tpu.data.ply import write_ply as j_write_ply
from rtnr_tpu.scene import Scene as JScene
from rtnr_tpu.utils.image import read_png as j_read_png
from rtnr_tpu.utils.image import write_png as j_write_png
from rtnr_tpu_torch import camera as tcam
from rtnr_tpu_torch.data.oct import read_oct, write_oct
from rtnr_tpu_torch.data.ply import read_ply, write_ply
from rtnr_tpu_torch.scene import Scene
from rtnr_tpu_torch.utils.image import read_png, write_png


def _same_camera(a, b):
    np.testing.assert_array_equal(a.K, b.K)
    assert (a.width, a.height, a.dists, a.fisheye) == (b.width, b.height, b.dists, b.fisheye)


def _same_scene(a, b):
    for k in ("points", "colors", "block_keys", "bb_min", "bb_max"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    assert a.num_blocks == b.num_blocks


# ---------------------------------------------------------------------------
# camera calibration files
# ---------------------------------------------------------------------------

CALIB_TEXTS = {
    "colmap": ("cameras.txt",
               "# Camera list with one line of data per camera:\n"
               "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n"
               "1 OPENCV 1920 1080 1400.5 1401.5 960.0 540.0 0.01 -0.02 0.001 0.002 0.0005\n"),
    "colmap_fisheye": ("cameras.txt",
                       "1 OPENCV_FISHEYE 640 480 300 300 320 240 0.1 0.2 0.3 0.4\n"),
    "matrix_comma_dists": ("calib.txt",
                           "640 480\n500 0 320\n0 500 240\n0 0 1\n0.1, 0.2, 0.0, 0.0, -0.1\n0\n"),
}


@pytest.mark.parametrize("case", sorted(CALIB_TEXTS))
def test_load_calibration_matches_jax(tmp_path, case):
    name, text = CALIB_TEXTS[case]
    f = tmp_path / name
    f.write_text(text)
    cam = tcam.Camera.load_calibration(f)
    _same_camera(cam, jcam.Camera.load_calibration(f))
    if case == "colmap":
        assert (cam.width, cam.height, cam.fx, cam.fy, cam.cx, cam.cy) == (
            1920, 1080, 1400.5, 1401.5, 960.0, 540.0)
        assert cam.dists == (0.01, -0.02, 0.001, 0.002, 0.0005) and not cam.fisheye
    elif case == "colmap_fisheye":
        assert cam.fisheye and cam.dists == (0.1, 0.2, 0.3, 0.4)
    else:
        assert cam.dists == (0.1, 0.2, 0.0, 0.0, -0.1)


@pytest.mark.parametrize("name, text, match", [
    ("cameras.txt", "1 SIMPLE_PINHOLE 640 480 300 320 240\n", "Unsupported camera model"),
    ("calib.txt", "640 480\n500 0 320\n0 500 240\n0 0 1\n0.1 0.2\n0\n", "expects 5 distortion"),
])
def test_bad_calibration_raises_as_jax(tmp_path, name, text, match):
    f = tmp_path / name
    f.write_text(text)
    for mod in (tcam, jcam):
        with pytest.raises(ValueError, match=match):
            mod.Camera.load_calibration(f)


@pytest.mark.parametrize("fisheye", [False, True])
def test_calibration_files_equal_jax_bytes(tmp_path, fisheye):
    """Matrix and binary files: the port writes the JAX package's bytes, and
    each package reads the other's file."""
    dists = (0.1, 0.2, 0.3, 0.4) if fisheye else (0.1, -0.2, 0.001, 0.002, 0.05)
    args = (1100.5, 1099.25, 960.0, 540.0, 1920, 1080, dists, fisheye)
    cam, jc = tcam.Camera.from_params(*args), jcam.Camera.from_params(*args)
    for save, load in (("save_calibration", "load_calibration"), ("save_binary", "load_binary")):
        a, b = tmp_path / f"port_{save}", tmp_path / f"jax_{save}"
        getattr(cam, save)(a)
        getattr(jc, save)(b)
        assert a.read_bytes() == b.read_bytes(), save
        _same_camera(getattr(tcam.Camera, load)(b), cam)
        _same_camera(getattr(jcam.Camera, load)(a), jc)
    assert (tmp_path / "port_save_binary").stat().st_size == 72 + 8 + 8 * len(dists) + 9


def test_binary_calibration_truncated(tmp_path):
    cam = tcam.Camera.from_params(100, 100, 32, 24, 64, 48, dists=(0.1, 0.2, 0.3, 0.4, 0.5))
    f = tmp_path / "calib.bin"
    cam.save_binary(f)
    raw = f.read_bytes()
    for cut in (10, 79, len(raw) - 8, len(raw) - 1):
        g = tmp_path / f"cut{cut}.bin"
        g.write_bytes(raw[:cut])
        with pytest.raises(ValueError, match="truncated"):
            tcam.Camera.load_binary(g)


def test_scaled_and_cam_proj_match_jax():
    cam = tcam.Camera.from_params(500.0, 400.0, 320.0, 240.0, 640, 480)
    s = cam.scaled(1280, 480)
    assert (s.fx, s.cx, s.fy, s.cy) == (1000.0, 640.0, 400.0, 240.0)
    _same_camera(s, jcam.Camera.from_params(500.0, 400.0, 320.0, 240.0, 640, 480).scaled(1280, 480))
    E = tcam.pose_from_quat_trans(1, 0, 0, 0, 0.5, -0.5, 2.0)
    np.testing.assert_array_equal(cam.cam_proj(E), jcam.Camera.from_params(
        500.0, 400.0, 320.0, 240.0, 640, 480).cam_proj(E))
    p = np.array([1.0, 2.0, 3.0, 1.0])
    assert np.isclose((cam.cam_proj(E) @ p)[2], (E @ p)[2])


@pytest.mark.parametrize("seed", [0, 1])
def test_quaternions_match_jax(seed):
    q = np.random.default_rng(seed).normal(size=(50, 7))
    for row in q:
        np.testing.assert_array_equal(tcam.quat_to_rotmat(*row[:4]), jcam.quat_to_rotmat(*row[:4]))
        np.testing.assert_array_equal(tcam.pose_from_quat_trans(*row),
                                      jcam.pose_from_quat_trans(*row))
    np.testing.assert_allclose(tcam.quat_to_rotmat(1, 0, 0, 0), np.eye(3), atol=1e-12)
    s = np.sqrt(0.5)
    np.testing.assert_allclose(tcam.quat_to_rotmat(s, 0, 0, s) @ [1, 0, 0], [0, 1, 0], atol=1e-12)
    np.testing.assert_allclose(tcam.quat_to_rotmat(2 * s, 0, 0, 2 * s),
                               tcam.quat_to_rotmat(s, 0, 0, s), atol=1e-12)


# ---------------------------------------------------------------------------
# trajectories
# ---------------------------------------------------------------------------

S = np.sqrt(0.5)
TRAJ_TEXTS = {
    "tum": ("tum", "# comment line\n0.0 1.0 2.0 3.0 0 0 0 1\n"
                   f"1.0 0.0 0.0 0.0 0 0 {S} {S}\n2.0 0.5 -1 4 0.1 0.2 0.3 0.9\n"),
    "colmap_one": ("colmap", "1 1 0 0 0 5.0 6.0 7.0 1 frame0.png\n"),
    "colmap_real": ("colmap",
                    "# Image list with two lines of data per image:\n"
                    "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
                    "#   POINTS2D[] as (X, Y, POINT3D_ID)\n"
                    "# Number of images: 3, mean observations per image: 2\n"
                    "1 1 0 0 0 5.0 6.0 7.0 1 frame0.png\n"
                    "100.25 200.5 -1 300.0 400.0 12345\n"
                    "2 1 0 0 0 1.0 2.0 3.0 1 frame1.png\n"
                    "\n"
                    "3 0.9 0.1 0.2 0.3 -1.0 -2.0 -3.0 1 frame2.png\n"
                    "7.0 8.0 9\n"),
    "colmap_pose_only": ("colmap", "1 1 0 0 0 5.0 6.0 7.0 1 frame0.png\n"
                                   "2 1 0 0 0 1.0 2.0 3.0 1 frame1.png\n"),
}


@pytest.mark.parametrize("case", sorted(TRAJ_TEXTS))
def test_trajectory_matches_jax(tmp_path, case):
    fmt, text = TRAJ_TEXTS[case]
    f = tmp_path / "traj.txt"
    f.write_text(text)
    t, jt = tcam.Trajectory.load(f, fmt=fmt), jcam.Trajectory.load(f, fmt=fmt)
    assert len(t) == len(jt) > 0
    for a, b in zip(t.entries, jt.entries):
        assert (a.frame_id, a.filename) == (b.frame_id, b.filename)
        np.testing.assert_array_equal(a.pose, b.pose)
    np.testing.assert_array_equal(t.world_to_cam_all(), jt.world_to_cam_all())
    np.testing.assert_allclose(t.world_to_cam(0) @ t[0].pose, np.eye(4), atol=1e-12)
    if case == "tum":
        np.testing.assert_allclose(t[0].pose[:3, 3], [1, 2, 3])
        np.testing.assert_allclose(t[1].pose[:3, :3] @ [1, 0, 0], [0, 1, 0], atol=1e-12)
        assert t[0].filename == "frame_1.png"
    else:
        np.testing.assert_allclose(t.world_to_cam(0)[:3, 3], [5, 6, 7], atol=1e-12)
        assert t[0].filename == "frame0.png"
    if case == "colmap_real":
        assert [e.frame_id for e in t.entries] == [1, 2, 3]


def test_trajectory_unknown_format(tmp_path):
    f = tmp_path / "t.txt"
    f.write_text("0 0 0 0 0 0 0 1\n")
    with pytest.raises(ValueError, match="Unknown trajectory format"):
        tcam.Trajectory.load(f, fmt="kitti")


# ---------------------------------------------------------------------------
# scene grid, cache, downsampling
# ---------------------------------------------------------------------------

def test_grid_keys_and_bounds():
    pts = np.array([[0.1, 0.1, 0.1], [0.9, 0.1, 0.1], [0.1, 0.9, 0.9]], np.float32)
    s = Scene.from_arrays(pts)
    assert s.num_blocks == (4, 4, 4)
    assert list(s.block_keys) == [0, 3, 0 + 3 * 4 + 3 * 16]
    lo, hi = s.block_bounds(np.array([s.block_keys[1]]))
    np.testing.assert_allclose(lo[0], [0.75, 0, 0])
    np.testing.assert_allclose(hi[0], [1.0, 0.25, 0.25])
    _same_scene(s, JScene.from_arrays(pts))
    assert Scene.from_arrays(np.zeros((0, 3), np.float32)).n_points == 0


@pytest.mark.parametrize("keep, seed", [(0.5, 0), (0.3, 7), (1.0, 1)])
def test_downsample_keeps_the_jax_rows(keep, seed):
    s = Scene.synthetic(10_000, seed=3, extent=1.0)
    d, jd = s.downsample(keep, seed=seed), JScene.synthetic(10_000, seed=3,
                                                            extent=1.0).downsample(keep, seed=seed)
    _same_scene(d, jd)
    if keep == 0.5:
        assert 0.45 * s.n_points < d.n_points <= 0.62 * s.n_points


def test_synthetic_room_matches_jax():
    s = Scene.synthetic_room(20_000, seed=2, n_clusters=5)
    _same_scene(s, JScene.synthetic_room(20_000, seed=2, n_clusters=5))
    _same_scene(s.sorted_by_block(), JScene.synthetic_room(20_000, seed=2,
                                                           n_clusters=5).sorted_by_block())
    for a, b in zip(s.device_arrays(256), JScene.synthetic_room(
            20_000, seed=2, n_clusters=5).device_arrays(256)):
        np.testing.assert_array_equal(a, b)


def test_npz_cache_read_by_both_packages(tmp_path):
    s = Scene.synthetic(5000, seed=2)
    out = s.save_cache(tmp_path / "port")
    assert out.name == "pcd.npz"
    _same_scene(JScene.load_cache(tmp_path / "port"), s)
    JScene.synthetic(5000, seed=2).save_cache(tmp_path / "jax")
    _same_scene(Scene.load_cache(tmp_path / "jax"), s)
    with np.load(out) as a, np.load(tmp_path / "jax" / "pcd.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert Scene.load_cache(tmp_path / "none") is None


# ---------------------------------------------------------------------------
# PLY
# ---------------------------------------------------------------------------

def _rand_cloud(n=1000, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)).astype(np.float32),
            rng.integers(0, 256, size=(n, 3), dtype=np.uint8))


@pytest.mark.parametrize("binary, color", [(True, True), (False, True), (True, False),
                                           (False, False)])
def test_ply_equals_jax(tmp_path, binary, color):
    pts, cols = _rand_cloud()
    cols = cols if color else None
    a, b = tmp_path / "port.ply", tmp_path / "jax.ply"
    write_ply(a, pts, cols, binary=binary)
    j_write_ply(b, pts, cols, binary=binary)
    assert a.read_bytes() == b.read_bytes()
    p, c = read_ply(b)
    jp, jc = j_read_ply(a)
    np.testing.assert_array_equal(p, jp)
    if binary:
        np.testing.assert_array_equal(p, pts)
    else:
        np.testing.assert_allclose(p, pts, rtol=1e-6)
    if color:
        np.testing.assert_array_equal(c, cols)
        np.testing.assert_array_equal(c, jc)
    else:
        assert c is None and jc is None


def test_ply_extra_props_skipped_and_big_endian(tmp_path):
    f = tmp_path / "x.ply"
    f.write_text("\n".join([
        "ply", "format ascii 1.0", "element vertex 2",
        "property float x", "property float y", "property float z",
        "property float intensity",
        "property uchar red", "property uchar green", "property uchar blue",
        "element face 1", "property list uchar int vertex_indices", "end_header",
        "1 2 3 0.5 10 20 30", "4 5 6 0.7 40 50 60", "3 0 1 0"]) + "\n")
    pts, cols = read_ply(f)
    np.testing.assert_allclose(pts, [[1, 2, 3], [4, 5, 6]])
    np.testing.assert_array_equal(cols, [[10, 20, 30], [40, 50, 60]])
    # binary big endian, a double coordinate type and an extra short
    dt = np.dtype([("x", ">f8"), ("y", ">f8"), ("z", ">f8"), ("s", ">i2")])
    rec = np.zeros(3, dt)
    rec["x"], rec["y"], rec["z"], rec["s"] = [1, 2, 3], [4, 5, 6], [7, 8, 9], [1, 2, 3]
    g = tmp_path / "be.ply"
    g.write_bytes(("ply\nformat binary_big_endian 1.0\nelement vertex 3\nproperty double x\n"
                   "property double y\nproperty double z\nproperty short s\nend_header\n")
                  .encode() + rec.tobytes())
    p, c = read_ply(g)
    jp, _ = j_read_ply(g)
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_array_equal(p, [[1, 4, 7], [2, 5, 8], [3, 6, 9]])
    assert c is None
    bad = tmp_path / "bad.ply"
    bad.write_bytes(b"noply\n")
    with pytest.raises(ValueError, match="magic"):
        read_ply(bad)


def test_scene_from_ply_with_cache(tmp_path):
    pts, cols = _rand_cloud(500, seed=1)
    f = tmp_path / "cloud.ply"
    write_ply(f, pts, cols)
    cache = tmp_path / "cache"
    s1 = Scene.from_file(f, cache_dir=cache)
    assert (cache / "pcd.npz").exists()
    _same_scene(s1, JScene.from_file(f))
    s2 = Scene.from_file(tmp_path / "nonexistent.ply", cache_dir=cache)  # cache hit
    _same_scene(s1, s2)
    (tmp_path / "c.e57").write_bytes(b"")
    with pytest.raises(ValueError, match="not an ASTM-E57 file"):
        Scene.from_file(tmp_path / "c.e57")
    with pytest.raises(ValueError, match="not supported"):
        Scene.from_file(tmp_path / "c.xyz")


# ---------------------------------------------------------------------------
# the reference's .oct cache
# ---------------------------------------------------------------------------

def test_oct_roundtrip(tmp_path):
    s = Scene.synthetic(20_000, seed=4, extent=3.0)
    f = tmp_path / "pcd.oct"
    assert s.save_oct(f)
    pts, cols, keys, nb = read_oct(f)
    ref = s.sorted_by_block()
    np.testing.assert_array_equal(pts, ref.points)
    np.testing.assert_array_equal(cols, ref.colors)
    np.testing.assert_array_equal(keys, ref.block_keys)
    assert nb == s.num_blocks
    back = Scene.from_oct(f)
    _same_scene(back, JScene(points=ref.points, colors=ref.colors, block_keys=ref.block_keys,
                             num_blocks=ref.num_blocks, bb_min=ref.bb_min, bb_max=ref.bb_max))
    raw = f.read_bytes()
    for cut in (8, 30, len(raw) - 1):
        g = tmp_path / f"cut{cut}.oct"
        g.write_bytes(raw[:cut])
        with pytest.raises(ValueError, match="truncated"):
            read_oct(g)


@pytest.mark.skipif(not (native.available() or native.build()), reason="native lib not built")
@pytest.mark.parametrize("n", [0, 1, 20_000])
def test_oct_bytes_equal_the_native_writer(tmp_path, n):
    s = Scene.synthetic(n, seed=5, extent=4.0)
    js = JScene.synthetic(n, seed=5, extent=4.0)
    a, b = tmp_path / "port.oct", tmp_path / "jax.oct"
    write_oct(a, s)
    assert native.write_oct(b, js)
    assert a.read_bytes() == b.read_bytes()
    if n:
        _same_scene(Scene.from_oct(b), JScene.from_oct(a))


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(20, 30, 3), (8, 8), (1, 1, 3)])
def test_png_equals_jax(tmp_path, shape):
    img = np.random.default_rng(0).integers(0, 256, size=shape, dtype=np.uint8)
    a, b = tmp_path / "port.png", tmp_path / "jax.png"
    write_png(a, img)
    j_write_png(b, img)
    assert a.read_bytes() == b.read_bytes()
    np.testing.assert_array_equal(read_png(a), img)
    np.testing.assert_array_equal(read_png(b), j_read_png(a))
    with pytest.raises(ValueError, match="uint8"):
        write_png(a, img.astype(np.float32))
