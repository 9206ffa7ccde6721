"""The port's training CLI (``rtnr_tpu_torch.apps.train_unet``) on the CPU
against the JAX package's CLI on one fixture: a PLY cloud, a 4-pose TUM
trajectory and a 64x32 calibration, features (8, 16), JAX's ``init_unet``
saved as msgpack and passed to both as ``--init-ckpt``. JAX's CLI runs once
(module fixture) under the suite's 8 virtual CPU devices, so it takes 8
frames a step; the port runs with ``--batch 8``, 8 frames stacked in one
step on one device. Tolerances (the U-Net runs in bf16 in both, rounded at
other places): logged losses within 2e-2 relative; saved parameters within
6 x lr of JAX's, since Adam moves a parameter by at most ~1.3 x lr a step in
its first two steps whatever the gradient; batch statistics within 2e-2 of
each leaf's largest magnitude."""

import json

import numpy as np
import pytest
import torch

import jax

from rtnr_tpu.apps.train_unet import main as j_main
from rtnr_tpu.models.unet import init_unet
from rtnr_tpu.utils.checkpoint import load_unet_variables as j_load
from rtnr_tpu.utils.checkpoint import save_msgpack as j_save
from rtnr_tpu_torch.apps.train_unet import main
from rtnr_tpu_torch.camera import Camera, Trajectory
from rtnr_tpu_torch.data.ply import write_ply
from rtnr_tpu_torch.pipeline import Renderer
from rtnr_tpu_torch.scene import Scene
from rtnr_tpu_torch.utils.checkpoint import load_unet_variables
from rtnr_tpu_torch.utils.image import write_png
from torch_threads import one_thread  # noqa: F401 (autouse: torch on one thread)

LR = 1e-3
STEPS = ["--steps", "2", "--log-every", "1", "--lr", str(LR), "--features", "8", "16"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """5,000 points in front of the camera, 4 TUM poses, a 64x32 matrix
    calibration and JAX's init_unet(8, 16) as msgpack."""
    tmp = tmp_path_factory.mktemp("train_cli")
    rng = np.random.default_rng(3)
    n = 5000
    pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-1.5, 1.5, n), rng.uniform(4, 8, n)],
                   1).astype(np.float32)
    cols = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    write_ply(tmp / "cloud.ply", pts, cols)
    Camera.from_params(40, 40, 32, 16, 64, 32, (0, 0, 0, 0, 0)).save_calibration(
        tmp / "calib.txt")
    (tmp / "traj.txt").write_text("0.0 0 0 0 0 0 0 1\n1.0 0.1 0 0 0 0 0 1\n"
                                  "2.0 0 0.1 -0.2 0 0 0 1\n3.0 -0.1 0 0.1 0 0.0087 0 0.9999\n")
    _, variables = init_unet(jax.random.PRNGKey(5), 32, 64, features=(8, 16))
    j_save(tmp / "init.msgpack", variables)
    return tmp, [str(tmp / "cloud.ply"), str(tmp / "traj.txt"), str(tmp / "calib.txt"),
                 "--init-ckpt", str(tmp / "init.msgpack")]


def _logs(out: str):
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


@pytest.fixture(scope="module")
def runs(files):
    """JAX's CLI (8 frames a step over 8 devices) and the port's (--batch 8)
    for 2 self-supervised steps: (log lines, checkpoint) of each."""
    import contextlib
    import io

    tmp, args = files
    out = {}
    for name, fn, extra in (("jax", j_main, []), ("port", lambda a: main(a, device="cpu"),
                                                  ["--batch", "8"])):
        buf = io.StringIO()
        ckpt = tmp / f"{name}.msgpack"
        with contextlib.redirect_stdout(buf):
            assert fn(args + ["--self-supervised", "-o", str(ckpt)] + STEPS + extra) == 0
        out[name] = (_logs(buf.getvalue()), ckpt)
    assert len(jax.devices()) == 8
    return out


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def test_logged_losses_match_jax(runs):
    got, want = runs["port"][0], runs["jax"][0]
    assert [r["step"] for r in got] == [r["step"] for r in want] == [0, 1]
    assert all(set(r) == {"step", "loss", "grad_norm", "sec"} for r in got)
    for g, w in zip(got, want):
        assert abs(g["loss"] - w["loss"]) <= 2e-2 * abs(w["loss"])
        assert np.isfinite(g["grad_norm"]) and g["grad_norm"] > 0


@pytest.mark.parametrize("collection", ["params", "batch_stats"])
def test_saved_variables_match_jax(runs, files, collection):
    got = dict(_leaves(load_unet_variables(runs["port"][1])[collection]))
    want = dict(_leaves(j_load(str(runs["jax"][1]))[collection]))
    init = dict(_leaves(j_load(str(files[0] / "init.msgpack"))[collection]))
    assert sorted(got) == sorted(want)
    moved = 0
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32, k
        if collection == "params":
            assert np.abs(g - w).max() <= 6 * LR, k
        else:
            assert np.abs(g - w).max() <= 2e-2 * np.abs(w).max(), k
        moved += int(not np.array_equal(g, init[k]))
    assert moved == len(want)  # every leaf moved in both


def test_checkpoints_load_both_ways(runs):
    """The port's checkpoint in JAX's loader and JAX's in the port's: the
    same tree, shapes and dtypes."""
    for path in (runs["port"][1], runs["jax"][1]):
        a = dict(_leaves(load_unet_variables(path)))
        b = dict(_leaves(j_load(str(path))))
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_png_targets_train_as_the_self_supervised_ones(files, runs, capsys):
    """--targets with the self-supervised frames written as frame_<i>.png
    gives the --self-supervised run's losses exactly."""
    tmp, args = files
    cam = Camera.load_calibration(args[2])
    traj = Trajectory.load(args[1])
    r = Renderer(Scene.from_file(args[0]), device="cpu")
    (tmp / "targets").mkdir(exist_ok=True)
    for i in range(len(traj)):
        write_png(tmp / "targets" / f"frame_{i + 1}.png",
                  r.compute_rgbd(cam, traj.world_to_cam(i))["rgb"])
    argv = args + ["--targets", str(tmp / "targets"), "-o", str(tmp / "png.msgpack"),
                   "--batch", "8"] + STEPS
    assert main(argv, device="cpu") == 0
    got = _logs(capsys.readouterr().out)
    assert [g["loss"] for g in got] == [w["loss"] for w in runs["port"][0]]


def test_missing_targets_exit_1_with_jax_message(files, capsys):
    tmp, args = files
    argv = args + ["-o", str(tmp / "none.msgpack")] + STEPS
    assert main(argv, device="cpu") == 1
    msg = capsys.readouterr().err
    assert j_main(argv) == 1
    assert msg == capsys.readouterr().err == (
        "No targets: pass --targets DIR or --self-supervised\n")


def test_cli_defaults_to_the_card_and_raises_without_it(files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tmp, args = files
    with pytest.raises(RuntimeError, match="CUDA"):
        main(args + ["--self-supervised", "-o", str(tmp / "card.msgpack")] + STEPS)
