"""The port's multi-rank rendering (rtnr_tpu_torch.parallel: mesh,
collectives, render) on four gloo ranks on the CPU, against the JAX
package's rtnr_tpu.parallel on four of the conftest's eight virtual CPU
devices with the same mesh shapes, at the JAX tests' sizes (40,000 points
at 64x64, the 8-point band case, U-Net features (4, 8)).

The ranks are spawned once for the module (``parallel.launch.start_ranks``:
fresh interpreters running ``_rank_cases`` below, which imports no JAX);
they run every case and return numpy results while this process computes
the JAX references."""

import numpy as np
import pytest
import torch

from rtnr_tpu_torch.camera import Camera
from rtnr_tpu_torch.scene import Scene

RANKS = 4
W = H = 64
BAND_W = BAND_H = 8


def _case_arrays():
    scene = Scene.synthetic(40_000, seed=0, extent=8.0)
    cam = Camera.from_params(60, 60, 32, 32, W, H)
    E = np.eye(4)
    E[2, 3] = 10.0
    pts, cols, valid = scene.sorted_by_block().device_arrays(pad_to_multiple=8 * 128)
    return pts, cols, valid, cam.cam_proj(E).astype(np.float32)


def _band_case():
    """8 points on one pixel, two a rank: rank 0 holds the global minimum
    2.000, rank 3 a point at 2.015 (in band), the rest lie behind it."""
    cam = Camera.from_params(10, 10, 4, 4, BAND_W, BAND_H)
    zs = [2.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 2.015]
    pts = np.array([[0, 0, z] for z in zs], np.float32)
    cols = np.array([[10 * (i + 1), 0, 0] for i in range(8)], np.uint8)
    return pts, cols, np.ones(8, bool), cam.cam_proj(np.eye(4)).astype(np.float32)


def _unet():
    from rtnr_tpu_torch.models.convert import from_flax_variables, init_unet_numpy
    from rtnr_tpu_torch.models.unet import UNet

    return UNet(from_flax_variables(init_unet_numpy(0, (4, 8))), features=(4, 8))


def _cli_files(d):
    """tests/test_torch_cli.py's cloud (5000 points), a 32x32 calibration, a
    3-pose trajectory (a batch of 4 pads one frame) and a (8, 16) U-Net
    checkpoint, under ``d``; returns the CLI's three positional arguments."""
    import pathlib

    from rtnr_tpu_torch.data.ply import write_ply
    from rtnr_tpu_torch.models.convert import init_unet_numpy
    from rtnr_tpu_torch.utils.checkpoint import save_msgpack

    d = pathlib.Path(d)
    rng = np.random.default_rng(1)
    n = 5000
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n), rng.uniform(4, 8, n)],
                   1).astype(np.float32)
    write_ply(d / "cloud.ply", pts, rng.integers(0, 256, (n, 3), dtype=np.uint8))
    Camera.from_params(30, 30, 16, 16, 32, 32, (0, 0, 0, 0, 0)).save_calibration(
        d / "calib.txt")
    (d / "traj.txt").write_text("0.0 0 0 0 0 0 0 1\n1.0 0.1 0 0 0 0 0 1\n"
                                "2.0 0 0.1 0 0 0 0 1\n")
    save_msgpack(d / "unet.msgpack", init_unet_numpy(0, (8, 16)))
    return [str(d / "cloud.ply"), str(d / "traj.txt"), str(d / "calib.txt")]


CLI_RUNS = {  # output dir -> (render CLI arguments on the ranks, serially)
    "batch_filtered": (["--batch", "4", "--stage", "filtered", "--depth"],
                       ["--stage", "filtered", "--depth"]),
    "batch_full": (["--batch", "2", "--stage", "full"], ["--stage", "full"]),
    "tiles_project": (["--tiles", "4", "--stage", "project", "--depth"],
                      ["--stage", "project", "--depth"]),
}
FULL_ARGS = ["--features", "8", "16", "--levels", "2"]
TRAIN_ARGS = ["--self-supervised", "--steps", "2", "--features", "8", "16", "--log-every", "1"]


def _cli_argv(d, name, argv):
    files = [str(d / f) for f in ("cloud.ply", "traj.txt", "calib.txt")]
    extra = ["--ckpt", str(d / "unet.msgpack")] + FULL_ARGS if "full" in argv else []
    return files + ["-o", str(d / name)] + argv + extra


def _run_clis(cli_dir, suffix, which):
    """The render CLI runs of ``CLI_RUNS`` (``which`` 0: on the ranks, 1:
    serially) into ``<name><suffix>``, then the training CLI; their exit
    codes and the training CLI's logged lines (loss, grad norm)."""
    import contextlib
    import io
    import json
    import pathlib

    from rtnr_tpu_torch.apps.render_trajectory import main
    from rtnr_tpu_torch.apps.train_unet import main as train_main

    d = pathlib.Path(cli_dir)
    rcs = {name: main(_cli_argv(d, name + suffix, runs[which]), device="cpu")
           for name, runs in CLI_RUNS.items()}
    files = [str(d / f) for f in ("cloud.ply", "traj.txt", "calib.txt")]
    batch = [] if which == 0 else ["--batch", str(RANKS)]
    out = ["-o", str(d / f"train{suffix}.msgpack")]
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rcs["train"] = train_main(files + TRAIN_ARGS + batch + out, device="cpu")
    logs = [json.loads(line) for line in log.getvalue().splitlines() if line.startswith("{")]
    return rcs, logs


def _rank_cases(cli_dir):
    """Every case on this rank; numpy results."""
    from rtnr_tpu_torch.parallel import collectives as C
    from rtnr_tpu_torch.parallel.mesh import make_mesh
    from rtnr_tpu_torch.parallel.render import (
        rasterize_point_sharded,
        render_filtered_sharded,
        render_full_batch,
    )

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    npy = lambda x: x.detach().cpu().numpy()
    out = {}
    pts, cols, valid, M = _case_arrays()

    # the mesh and the collectives on a (2, 2) mesh
    mesh = make_mesh((2, 2))
    r = mesh.rank
    x = torch.tensor([float(r), 10.0 - r, 0.5 * r])
    out["mesh"] = {"shape": mesh.shape, "index": (mesh.axis_index("batch"),
                                                  mesh.axis_index("points")),
                   "pmin": npy(C.pmin(x, mesh, "points")), "pmax": npy(C.pmax(x, mesh, "batch")),
                   "psum": npy(C.psum(x, mesh, "points")),
                   "psum_i": npy(C.psum(x.to(torch.int32), mesh, "batch")),
                   "gather": npy(C.all_gather(x, mesh, "points")),
                   "up": npy(C.ppermute_ring(x, mesh, "batch", 1)),
                   "down": npy(C.ppermute_ring(x, mesh, "points", -1)),
                   "rows": npy(C.shard_rows(torch.arange(8), mesh, "points")),
                   "frames": npy(C.gather_frames(x[None] + 100 * mesh.axis_index("batch"),
                                                 mesh))}
    alone = make_mesh((1, 1))  # this rank by itself inside the four-rank world
    out["alone"] = {"world": alone.world, "ranks": alone.group_ranks("points"),
                    "psum": npy(C.psum(x, alone, "points")), "bad": None}
    try:
        make_mesh((2, 1))
    except ValueError as e:
        out["alone"]["bad"] = str(e)

    mesh = make_mesh((1, RANKS))
    blk = lambda a: t(C.shard_rows(a, mesh, "points"))
    rgb, depth = rasterize_point_sharded(blk(pts), blk(cols), blk(valid), t(M), mesh,
                                         width=W, height=H)
    out["point"] = (npy(rgb), npy(depth))
    bp, bc, bv, bM = _band_case()
    rgb, depth = rasterize_point_sharded(blk(bp), blk(bc), blk(bv), t(bM), mesh, width=BAND_W,
                                         height=BAND_H)
    out["band"] = (npy(rgb), npy(depth))

    mesh = make_mesh((2, 2))
    blk = lambda a: t(C.shard_rows(a, mesh, "points"))
    Ms = torch.stack([t(M), t(M)])
    f = render_filtered_sharded(blk(pts), blk(cols), blk(valid), Ms, mesh, width=W, height=H)
    out["filtered_local"] = {k: npy(v) for k, v in f.items()}
    out["filtered"] = {k: npy(C.gather_frames(v, mesh)) for k, v in f.items()}

    # four frames at two poses; the U-Net on each local frame
    M2 = M.copy()
    M2[0, 3] += 1.5
    Ms = t(np.stack([M, M2, M, M2]))
    full = render_full_batch(blk(pts), blk(cols), blk(valid), Ms, mesh, _unet(), width=W,
                             height=H)
    out["full"] = {k: npy(C.gather_frames(full[k], mesh)) for k in ("rgb_f", "rgb_unet",
                                                                    "raw_rgb")}
    # the CLIs in this world of four ranks
    out["cli"] = _run_clis(cli_dir, "", 0)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the ranks, compute the JAX references and the serial CLI runs
    meanwhile, then wait."""
    import pathlib

    from rtnr_tpu_torch.parallel.launch import start_ranks

    root = pathlib.Path(__file__).resolve().parents[1]
    cli_dir = tmp_path_factory.mktemp("cli")
    _cli_files(cli_dir)
    procs = start_ranks("tests.test_torch_parallel:_rank_cases", RANKS,
                        {"cli_dir": str(cli_dir)}, device="cpu", extra_path=[str(root)],
                        timeout=400)
    import jax
    import jax.numpy as jnp

    from rtnr_tpu.parallel import make_mesh as jmesh
    from rtnr_tpu.parallel import rasterize_point_sharded as jpoint
    from rtnr_tpu.parallel import render_filtered_sharded as jfiltered

    # jitted: shard_map bodies run op by op otherwise (~40 s for the raster)
    jpoint = jax.jit(jpoint, static_argnames=("mesh", "width", "height"))
    devs = jax.devices()[:RANKS]
    pts, cols, valid, M = (jnp.asarray(a) for a in _case_arrays())
    ref = {"point": jpoint(pts, cols, valid, M, jmesh((1, RANKS), devices=devs), width=W,
                           height=H)}
    bp, bc, bv, bM = (jnp.asarray(a) for a in _band_case())
    ref["band"] = jpoint(bp, bc, bv, bM, jmesh((1, RANKS), devices=devs), width=BAND_W,
                         height=BAND_H)
    ref["filtered"] = jfiltered(pts, cols, valid, jnp.stack([M, M]),
                                jmesh((2, 2), devices=devs), width=W, height=H)
    ref = jax.tree.map(np.asarray, ref)
    ref["cli"] = _run_clis(cli_dir, "_serial", 1)
    ref["cli_dir"] = cli_dir
    return procs.wait(), ref


def test_mesh_on_one_rank():
    """Without a launcher: a one-rank mesh, JAX's shape dict, sizes that do
    not multiply to the world raise."""
    from rtnr_tpu_torch.parallel.mesh import make_mesh

    m = make_mesh()
    assert m.shape == {"batch": 1, "points": 1} and m.world == 1
    assert m.axis_index("points") == 0
    with pytest.raises(ValueError, match="needs 12 ranks"):
        make_mesh((3, 4))


def test_mesh_and_collectives(ranks):
    res, _ = ranks
    for r, out in enumerate(res):
        m = out["mesh"]
        b, p = divmod(r, 2)  # row-major, as JAX reshapes its devices
        assert m["shape"] == {"batch": 2, "points": 2} and m["index"] == (b, p)
        x = lambda q: np.array([float(q), 10.0 - q, 0.5 * q], np.float32)
        row = [2 * b, 2 * b + 1]  # the points axis through r
        col = [p, 2 + p]  # the batch axis through r
        np.testing.assert_array_equal(m["pmin"], np.minimum(x(row[0]), x(row[1])))
        np.testing.assert_array_equal(m["pmax"], np.maximum(x(col[0]), x(col[1])))
        np.testing.assert_array_equal(m["psum"], x(row[0]) + x(row[1]))
        np.testing.assert_array_equal(m["psum_i"], (x(col[0]).astype(np.int32)
                                                    + x(col[1]).astype(np.int32)))
        np.testing.assert_array_equal(m["gather"], np.stack([x(row[0]), x(row[1])]))
        # shift +1 on a ring of 2: receive from the other rank
        np.testing.assert_array_equal(m["up"], x(col[1 - b]))
        np.testing.assert_array_equal(m["down"], x(row[1 - p]))
        np.testing.assert_array_equal(m["rows"], np.arange(4 * p, 4 * p + 4))
        np.testing.assert_array_equal(m["frames"][:, 0], [100.0 * 0 + p, 100.0 + 2 + p])
        a = out["alone"]
        assert a["world"] == 1 and a["ranks"] == [r] and "needs 2 ranks" in a["bad"]
        np.testing.assert_array_equal(a["psum"], x(r))


def test_point_sharded_raster_matches_jax_and_one_device(ranks):
    from rtnr_tpu_torch.ops.raster import rasterize

    res, ref = ranks
    pts, cols, valid, M = (torch.from_numpy(a) for a in _case_arrays())
    rgb1, d1 = rasterize(pts, cols, M, width=W, height=H, valid=valid)
    for out in res:
        for got, want in zip(out["point"], ref["point"]):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(out["point"][0], rgb1.numpy())
        np.testing.assert_array_equal(out["point"][1], d1.numpy())


def test_band_uses_global_min_across_ranks(ranks):
    res, ref = ranks
    for out in res:
        rgb, depth = out["band"]
        assert depth[4, 4] == np.float32(2.0)
        assert rgb[4, 4, 0] == 45  # the average of colours 10 and 80
        np.testing.assert_array_equal(rgb, ref["band"][0])
        np.testing.assert_array_equal(depth, ref["band"][1])


def test_filtered_sharded_matches_jax(ranks):
    res, ref = ranks
    for r, out in enumerate(res):
        for k in ("raw_rgb", "raw_depth", "rgb", "depth", "mask", "unet_input"):
            np.testing.assert_array_equal(out["filtered"][k], ref["filtered"][k], err_msg=k)
            # the rank's own frame is frame (rank's batch index) of the batch
            np.testing.assert_array_equal(out["filtered_local"][k][0],
                                          ref["filtered"][k][r // 2], err_msg=k)


def test_full_batch_matches_one_device_render_full(ranks):
    from rtnr_tpu_torch.pipeline import render_full

    res, _ = ranks
    pts, cols, valid, M = _case_arrays()
    M2 = M.copy()
    M2[0, 3] += 1.5
    unet = _unet()
    t = torch.from_numpy
    for f, Mf in enumerate([M, M2, M, M2]):
        want = render_full(t(pts), t(cols), t(valid), t(Mf), unet, width=W, height=H)
        for out in res:
            np.testing.assert_array_equal(out["full"]["rgb_f"][f], want["rgb_f"].numpy())
            np.testing.assert_array_equal(out["full"]["rgb_unet"][f], want["rgb"].numpy())
            np.testing.assert_array_equal(out["full"]["raw_rgb"][f], want["raw_rgb"].numpy())
    assert res[0]["full"]["rgb_unet"].shape == (4, H, W, 3)


def test_clis_on_four_ranks_write_the_serial_outputs(ranks):
    """The render CLI's --batch (filtered, full) and --tiles (project) on the
    four ranks: exit 0 and the serial CLI's PNG bytes (rank 0 writes them);
    the training CLI on four ranks (one frame a rank, global-batch
    BatchNorm) against one process stepping the same four frames, all in
    bf16, whose summation order differs between the two.

    Bounds, from the readings of this case (two Adam steps at lr 1e-4): the
    logged losses to rtol 1e-3 (read 2.4e-5) and grad norms to rtol 2e-3
    (read 5.4e-4; unscaled gradient sums read 4x). The parameters: their
    mean difference below 2e-5 (read 5.2e-6, a mean update being 1.5e-4;
    without the gradient sum 1.2e-4, without the BatchNorm sync 6.1e-5),
    each within 4e-4, what two steps move a parameter whose gradient's sign
    the summation order decides (Adam's first steps are ~lr times the
    sign). The BatchNorm running statistics within rtol 1e-3, atol 2e-4
    (read: 3.3e-4 at a variance of 1.17, means within 1.5e-4; without the
    sync 3.5e-2)."""
    from rtnr_tpu_torch.utils.checkpoint import load_msgpack

    res, ref = ranks
    d = ref["cli_dir"]
    (rcs, logs), (rcs1, logs1) = res[0]["cli"], ref["cli"]
    assert rcs == {k: 0 for k in rcs1} == rcs1
    assert len(logs) == len(logs1) == 2 and not any(r["cli"][1] for r in res[1:])
    for key, rtol in (("loss", 1e-3), ("grad_norm", 2e-3)):
        np.testing.assert_allclose([m[key] for m in logs], [m[key] for m in logs1], rtol=rtol,
                                   err_msg=key)
    for name in CLI_RUNS:
        got = {p.name: p.read_bytes() for p in sorted((d / name).glob("*.png"))}
        want = {p.name: p.read_bytes() for p in sorted((d / f"{name}_serial").glob("*.png"))}
        assert len(got) >= 3 and got == want, name
    a, b = (load_msgpack(d / f) for f in ("train.msgpack", "train_serial.msgpack"))

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{path}/{k}")
        else:
            yield path, np.asarray(tree)

    want = dict(leaves(b))
    got = dict(leaves(a))
    assert got.keys() == want.keys()
    params = [p for p in got if p.startswith("/params/")]
    stats = [p for p in got if p.startswith("/batch_stats/")]
    assert params and stats and len(params) + len(stats) == len(got)
    for path in params:
        np.testing.assert_allclose(got[path], want[path], rtol=0, atol=4e-4, err_msg=path)
    diff = np.concatenate([np.abs(got[p] - want[p]).ravel() for p in params])
    assert diff.mean() < 2e-5, diff.mean()
    for path in stats:
        np.testing.assert_allclose(got[path], want[path], rtol=1e-3, atol=2e-4, err_msg=path)


def test_cli_tiles_need_as_many_ranks(tmp_path, capsys):
    from rtnr_tpu_torch.apps.render_trajectory import main

    files = _cli_files(tmp_path)
    assert main(files + ["-o", str(tmp_path / "out"), "--tiles", "2"], device="cpu") == 1
    assert "needs 2 ranks" in capsys.readouterr().err
