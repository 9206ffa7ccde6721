"""Training pairs from a scanner file in the port
(``rtnr_tpu_torch.data.pairs.generate_pairs_from_e57`` and
``rtnr_tpu_torch.apps.generate_pairs``) against the JAX package's, on the
CPU: JAX's ``tests/test_pairs.py`` fixture (20,000 points, 128x96 photos
embedded as Pillow JPEGs, float coordinates) with a second photo; the pairs
(photo, depth, projected RGB, pose, intrinsics) equal JAX's bit for bit, the
CLI writes the same PNG bytes, npz arrays, ``traj.txt`` and ``calib.txt``;
``--no-depth`` and ``--limit`` work; a ``.ply`` or a file without photos
exits 1; the entry points default to the card.

The second photo's pose is rotated. There JAX's ``project_points`` (one
``points @ M.T`` on XLA:CPU) and the port's (each row summed op by op in
f32, the reference's order) give depths up to 1 f32 ulp apart; pixels and
colours agree. So that pose's depth is held to 1 ulp, and to the f32
op-order projection bit for bit; everything else is bit for bit."""

import io
import json

import numpy as np
import pytest
from PIL import Image

from rtnr_tpu.apps import generate_pairs as jcli
from rtnr_tpu.camera import Camera as JCamera
from rtnr_tpu.data import pairs as jpairs
from rtnr_tpu.data.e57_write import E57Image, scan_from_arrays, write_e57
from rtnr_tpu.pipeline import Renderer as JRenderer
from rtnr_tpu.scene import Scene as JScene
from rtnr_tpu_torch.apps import generate_pairs as cli
from rtnr_tpu_torch.data import pairs
from torch_threads import one_thread  # noqa: F401 (autouse: torch on one thread)

W, H = 128, 96


def _jpeg(rgb):
    b = io.BytesIO()
    Image.fromarray(rgb, "RGB").save(b, "JPEG", quality=98)
    return b.getvalue()


def _pose_tuple_for_extrinsics(E):
    """E57 image pose (qw qx qy qz tx ty tz) such that getImage returns
    world_to_cam == E (inverts the axis-flip convention)."""
    D = np.diag([1.0, -1.0, -1.0, 1.0])
    P = np.linalg.inv(E) @ D
    q = cli.rotmat_to_quat(P[:3, :3])
    return (*q, P[0, 3], P[1, 3], P[2, 3])


def _same_depth(got, want, k):
    """Pose 0 (no rotation): bit for bit; pose 1 (rotated): within 1 ulp."""
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    if k == 0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_max_ulp(got, want, maxulp=1)
        np.testing.assert_array_equal(got < 3e38, want < 3e38)


def _op_order_depth(scene, cam, E):
    """Per-pixel minimum of the f32 op-order depth ((x*m0 + y*m1) + z*m2) + m3
    over the pixels that the projection assigns (numpy)."""
    M = cam.cam_proj(E).astype(np.float32)
    x, y, z = scene.points[:, 0], scene.points[:, 1], scene.points[:, 2]
    r0, r1, r2 = (((x * M[i, 0] + y * M[i, 1]) + z * M[i, 2]) + M[i, 3] for i in range(3))
    safe = np.where(r2 > 0, r2, np.float32(1))
    u, v = np.rint(r0 / safe).astype(np.int64), np.rint(r1 / safe).astype(np.int64)
    ok = (r2 > 0) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    depth = np.full(H * W, np.finfo(np.float32).max, np.float32)
    np.minimum.at(depth, (v * W + u)[ok], r2[ok])
    return depth.reshape(H, W)


def _poses():
    E0 = np.eye(4)
    E0[2, 3] = 6.0
    E1 = np.eye(4)
    c, s = np.cos(0.2), np.sin(0.2)
    E1[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    E1[:3, 3] = [0.4, -0.2, 6.5]
    return [E0, E1]


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """JAX's test_pairs fixture: the scene's own projections from JAX's
    Renderer, embedded as quality-98 Pillow JPEGs in a float-coordinate
    .e57 (written by JAX's writer), plus the same scan without photos."""
    scene = JScene.synthetic(20_000, seed=7, extent=4.0)
    cam = JCamera.from_params(120.0, 120.0, W / 2, H / 2, W, H)
    r = JRenderer(scene)
    refs = [r.compute_rgbd(cam, E) for E in _poses()]
    images = [E57Image(jpeg_bytes=_jpeg(ref["rgb"]), image_width=W, image_height=H,
                       focal_length=0.05, pixel_width=0.05 / 120.0, pixel_height=0.05 / 120.0,
                       principal_point_x=W / 2, principal_point_y=H / 2,
                       pose=_pose_tuple_for_extrinsics(E))
              for ref, E in zip(refs, _poses())]
    d = tmp_path_factory.mktemp("e57pairs")
    scan = [scan_from_arrays(scene.points.astype(np.float64), scene.colors, cartesian_scale=0.0)]
    write_e57(d / "scan.e57", scan, images)
    write_e57(d / "bare.e57", scan)
    return d, cam, refs, scene


@pytest.fixture(scope="module")
def made(fixture):
    d = fixture[0]
    return (pairs.generate_pairs_from_e57(d / "scan.e57", cache_dir=d / "pc", device="cpu"),
            jpairs.generate_pairs_from_e57(d / "scan.e57", cache_dir=d / "jc"))


def test_pairs_from_e57_equal_jax(made, fixture):
    got, want = made
    _, cam, refs, scene = fixture
    assert len(got) == len(want) == 2
    for k, (g, w, ref, E) in enumerate(zip(got, want, refs, _poses())):
        for f in ("image", "proj_rgb", "world_to_cam"):
            a, b = getattr(g, f), np.asarray(getattr(w, f))
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        _same_depth(g.depth, np.asarray(w.depth), k)
        np.testing.assert_array_equal(g.camera.K, w.camera.K)
        assert (g.camera.width, g.camera.height) == (W, H)
        assert tuple(g.camera.dists) == tuple(w.camera.dists) == (0.0,) * 5
        # aligned with the direct render: its depth, pose and intrinsics
        _same_depth(g.depth, np.asarray(ref["depth"]), k)
        np.testing.assert_array_equal(g.depth, _op_order_depth(scene, cam, E))
        np.testing.assert_allclose(g.world_to_cam, E, atol=1e-9)
        np.testing.assert_allclose(np.diag(g.camera.K), np.diag(cam.K), rtol=1e-9)
        assert (g.depth < 3e38).mean() > 0.05


def _run_both(fixture, tmp_path, extra):
    d = fixture[0]
    outs = {}
    for tag, main, kw in (("port", cli.main, {"device": "cpu"}), ("jax", jcli.main, {})):
        out = tmp_path / tag
        rc = main([str(d / "scan.e57"), "-o", str(out), "--cache-dir", str(tmp_path / f"{tag}c")]
                  + extra, **kw)
        assert rc == 0
        outs[tag] = out
    return outs["port"], outs["jax"]


@pytest.mark.parametrize("extra, n_frames, depth", [([], 2, True), (["--limit", "1"], 1, True),
                                                    (["--no-depth"], 2, False)])
def test_cli_files_equal_jax(fixture, tmp_path, capsys, extra, n_frames, depth):
    port, jax_out = _run_both(fixture, tmp_path, extra)
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.startswith("{")]
    assert [(r["pairs"], r["resolution"]) for r in lines] == [(n_frames, [W, H])] * 2
    names = sorted(p.name for p in port.iterdir())
    assert names == sorted(p.name for p in jax_out.iterdir())
    want = {f"frame_{i + 1}.png" for i in range(n_frames)} | {"traj.txt", "calib.txt"}
    if depth:
        want |= {f"depth_{i + 1}.npz" for i in range(n_frames)}
    assert set(names) == want
    for name in names:
        if name.endswith(".npz"):
            zp, zj = np.load(port / name), np.load(jax_out / name)
            assert sorted(zp.files) == sorted(zj.files) == ["K", "depth", "proj_rgb",
                                                            "world_to_cam"]
            for k in zp.files:
                assert zp[k].dtype == zj[k].dtype
                if k == "depth":
                    _same_depth(zp[k], zj[k], int(name[6:-4]) - 1)
                else:
                    np.testing.assert_array_equal(zp[k], zj[k], err_msg=f"{name}:{k}")
        else:
            assert (port / name).read_bytes() == (jax_out / name).read_bytes(), name


def test_cli_refuses_what_jax_refuses(fixture, tmp_path, capsys):
    d = fixture[0]
    ply = tmp_path / "c.ply"
    ply.write_bytes(b"ply\n")
    for args in ([str(ply)], [str(d / "bare.e57")]):
        for tag, main, kw in (("port", cli.main, {"device": "cpu"}), ("jax", jcli.main, {})):
            assert main(args + ["-o", str(tmp_path / tag)], **kw) == 1, (tag, args)
    err = capsys.readouterr().err
    assert err.count("requires an .e57 file") == 2 and err.count("No embedded images") == 2


def test_entry_points_default_to_the_card(fixture, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    d = fixture[0]
    with pytest.raises(RuntimeError, match="CUDA"):
        pairs.generate_pairs_from_e57(d / "scan.e57", cache_dir=d / "pc")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([str(d / "scan.e57"), "-o", str(tmp_path / "o"), "--cache-dir", str(d / "pc")])
