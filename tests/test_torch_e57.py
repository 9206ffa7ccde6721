"""The port's E57 chain (``rtnr_tpu_torch.data.e57_write``, ``data.e57`` on
the host library's container decoder, ``Scene.from_file``) against the JAX
package's: the writers give the same bytes for the same inputs
(ScaledInteger, single and double floats, spherical coordinates, invalid
states, colour limits, bitstreams that straddle packets, several scans,
embedded images); each package's reader decodes the other's files field for
field; ``assemble_scan`` agrees with and without skip decimation; a CRC
corruption is caught; ``get_image`` returns the same photo, pose and
intrinsics; ``Scene.from_file(.e57)`` gives the same scene and cache."""

import io

import numpy as np
import pytest
from PIL import Image

from rtnr_tpu.data import e57 as je57
from rtnr_tpu.data import e57_write as jw
from rtnr_tpu.scene import Scene as JScene
from rtnr_tpu_torch.data import e57 as pe57
from rtnr_tpu_torch.data import e57_write as pw
from rtnr_tpu_torch.data.jpeg import encode_jpeg
from rtnr_tpu_torch.scene import Scene

CASES = ["scaled", "float_single", "double", "spherical", "invalid", "color_limits",
         "straddle", "two_scans", "images"]


def _cloud(n, seed, extent=3.0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-extent, extent, (n, 3))
    cols = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    return pts, cols


def _jpeg_pil(rgb):
    b = io.BytesIO()
    Image.fromarray(rgb).save(b, "JPEG", quality=98)
    return b.getvalue()


def _case(m, case):
    """(scans, images) of one case, built with the writer module ``m``
    (JAX's or the port's) from the same seeded arrays."""
    pts, cols = _cloud(3000, seed=CASES.index(case))
    pose = (0.9238795325112867, 0.0, 0.3826834323650898, 0.0, 1.5, -2.25, 0.125)
    if case == "scaled":
        return [m.scan_from_arrays(pts, cols, pose=pose)], []
    if case == "float_single":
        return [m.scan_from_arrays(pts, cols, cartesian_scale=0.0)], []
    if case == "double":
        inv = np.zeros(len(pts), np.int64)
        f = [m.E57Field(k, "double", pts[:, i])
             for i, k in enumerate(("cartesianX", "cartesianY", "cartesianZ"))]
        f.append(m.E57Field("cartesianInvalidState", "integer", inv, 0, 2))
        return [m.E57Scan(fields=f, name="dbl", pose=pose)], []
    if case == "spherical":
        rng = np.random.default_rng(11)
        sph = np.stack([rng.uniform(-np.pi, np.pi, 3000), rng.uniform(-1.2, 1.2, 3000),
                        rng.uniform(0.5, 30.0, 3000)], 1)
        return [m.scan_from_arrays(sph, cols, spherical=True, cartesian_scale=1e-5),
                m.scan_from_arrays(sph, None, spherical=True, cartesian_scale=0.0)], []
    if case == "invalid":
        inv = np.random.default_rng(12).integers(0, 3, len(pts))
        return [m.scan_from_arrays(pts, cols, invalid=inv)], []
    if case == "color_limits":
        rng = np.random.default_rng(13)
        c12 = rng.integers(100, 4000, (len(pts), 3))
        f = [m.E57Field(k, "scaled", pts[:, i], minimum=-40000, maximum=40000, scale=1e-4,
                        offset=0.5)
             for i, k in enumerate(("cartesianX", "cartesianY", "cartesianZ"))]
        f += [m.E57Field(k, "integer", c12[:, i], 100, 4000)
              for i, k in enumerate(("colorRed", "colorGreen", "colorBlue"))]
        f.append(m.E57Field("intensity", "integer", rng.integers(0, 5001, len(pts)), 0, 5000))
        limits = {"colorRedMinimum": 100, "colorRedMaximum": 4000, "colorGreenMinimum": 100,
                  "colorGreenMaximum": 3000.5, "colorBlueMinimum": 0, "colorBlueMaximum": 4095}
        return [m.E57Scan(fields=f, color_limits=limits,
                          intensity_limits={"intensityMinimum": 0.0,
                                            "intensityMaximum": 5000.0})], []
    if case == "straddle":
        # 17- and 13-bit records over several 64 KiB packets: records and bytes
        # straddle packet boundaries
        big, bcols = _cloud(60_000, seed=14, extent=3.2767)
        inten = np.random.default_rng(15).integers(0, 8192, len(big))
        s = m.scan_from_arrays(big, bcols)
        s.fields.append(m.E57Field("intensity", "integer", inten, 0, 8191))
        return [s], []
    if case == "two_scans":
        p2, c2 = _cloud(1500, seed=16)
        return [m.scan_from_arrays(pts, cols, pose=pose, name="a"),
                m.scan_from_arrays(p2, c2, pose=(1.0, 0, 0, 0, 10.0, 0, 0), name="b")], []
    assert case == "images"
    rgb = np.random.default_rng(17).integers(0, 256, (24, 32, 3), dtype=np.uint8)
    images = [m.E57Image(jpeg_bytes=jb, name=f"im{k}", pose=pose, image_width=32,
                         image_height=24, focal_length=0.05, pixel_width=0.05 / 30.0,
                         pixel_height=0.05 / 31.0, principal_point_x=16.5,
                         principal_point_y=11.25)
              for k, jb in enumerate([_jpeg_pil(rgb), encode_jpeg(rgb, 95)])]
    return [m.scan_from_arrays(pts, cols)], images


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    d = tmp_path_factory.mktemp("e57")
    out = {}
    for case in CASES:
        files = (d / f"{case}_jax.e57", d / f"{case}_port.e57")
        for m, f in zip((jw, pw), files):
            scans, images = _case(m, case)
            m.write_e57(f, scans, images)
        out[case] = files
    return out


@pytest.mark.parametrize("case", CASES)
def test_writer_bytes_equal_jax(written, case):
    fj, fp = written[case]
    assert fp.read_bytes() == fj.read_bytes()


def _same_raw(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if k == "pose":
            assert a[k] == b[k]
        else:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_readers_decode_each_others_files(written, case):
    fj, fp = written[case]
    with pe57.E57Reader(fj) as pr, je57.E57Reader(fp) as jr:
        assert pr._f.meta == jr._f.meta
        assert pr.scan_count == jr.scan_count and pr.image_count == jr.image_count
        for i in range(pr.scan_count):
            _same_raw(pr.get_scan_raw(i), jr.get_scan_raw(i))
            for g, w in zip(pr.get_scan_cloud(i), jr.get_scan_cloud(i)):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
    for g, w in zip(pe57.read_e57(fj), je57.read_e57(fp)):
        np.testing.assert_array_equal(g, w)


def test_scaled_coordinates_decode_to_the_written_grid(written):
    pts, _ = _cloud(3000, seed=CASES.index("scaled"))
    with pe57.E57Reader(written["scaled"][1]) as r:
        x = r.get_scan_raw(0)["cartesianX"]
    np.testing.assert_allclose(x, np.rint(pts[:, 0] / 1e-4) * 1e-4, rtol=0, atol=1e-12)


@pytest.mark.parametrize("skip", [0, 3])
def test_assemble_scan_equals_jax(skip):
    rng = np.random.default_rng(20)
    n = 5000
    scan = {"sphericalAzimuth": rng.uniform(-3, 3, n), "sphericalElevation": rng.uniform(-1, 1, n),
            "sphericalRange": rng.uniform(1, 20, n),
            "sphericalInvalidState": rng.integers(0, 3, n).astype(np.int8),
            "colorRed": rng.uniform(0, 4095, n), "colorGreen": rng.uniform(0, 4095, n),
            "colorBlue": rng.uniform(0, 4095, n), "pose": (0.8, 0.1, -0.2, 0.3, 1.0, 2.0, -3.0)}
    limits = {"colorRedMaximum": 4095.0, "colorGreenMinimum": 10.0, "colorGreenMaximum": 4000.0}
    got = pe57.assemble_scan(scan, limits, skip=skip, rng_seed=5)
    want = je57.assemble_scan(scan, limits, skip=skip, rng_seed=5)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert len(got[0]) < n


def test_crc_corruption_is_detected(written, tmp_path):
    raw = bytearray(written["scaled"][1].read_bytes())
    raw[3 * 1024 + 17] ^= 0x40
    bad = tmp_path / "bad.e57"
    bad.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="page CRC mismatch at offset 3072"):
        pe57.E57Reader(bad)
    with pytest.raises(ValueError, match="cannot open E57 file .*: cannot open file"):
        Scene.from_file(tmp_path / "missing.e57")


def test_get_image_equals_jax(written):
    fj, fp = written["images"]
    with pe57.E57Reader(fp) as pr, je57.E57Reader(fj) as jr:
        assert pr.image_count == 2
        for i in range(2):
            for g, w in zip(pr.get_image(i), jr.get_image(i)):
                assert g.dtype == w.dtype and g.shape == w.shape
                np.testing.assert_array_equal(g, w)


def test_scene_from_e57_equals_jax_with_cache(written, tmp_path):
    f = written["two_scans"][1]
    got = Scene.from_file(f, cache_dir=tmp_path / "p")
    want = JScene.from_file(f, cache_dir=tmp_path / "j")
    for k in ("points", "colors", "block_keys", "bb_min", "bb_max"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
    assert tuple(got.num_blocks) == tuple(want.num_blocks)
    assert got.n_points == 4500
    zp, zj = np.load(tmp_path / "p" / "pcd.npz"), np.load(tmp_path / "j" / "pcd.npz")
    assert sorted(zp.files) == sorted(zj.files)
    for k in zp.files:
        np.testing.assert_array_equal(zp[k], zj[k], err_msg=k)
    # a cache hit never reads the path
    again = Scene.from_file(tmp_path / "gone.e57", cache_dir=tmp_path / "p")
    np.testing.assert_array_equal(again.points, got.points)
