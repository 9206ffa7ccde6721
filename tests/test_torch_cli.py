"""The port's render CLI (``rtnr_tpu_torch.apps.render_trajectory``) on the
CPU against the JAX package's CLI on tests/test_cli.py's fixture: the
project and filtered stages write the JAX CLI's PNG bytes; the full stage
writes the port Renderer's ``compute_full`` frames; ``--batch`` in one
process writes the serial frames; ``--tiles`` without as many ranks and the
full stage without a checkpoint exit 1 (the CLI on several ranks:
tests/test_torch_parallel.py)."""

import json

import numpy as np
import pytest
import torch

from rtnr_tpu.apps.render_trajectory import main as j_main
from rtnr_tpu_torch.apps.render_trajectory import main
from rtnr_tpu_torch.camera import Camera, Trajectory
from rtnr_tpu_torch.config import RenderConfig
from rtnr_tpu_torch.data.ply import write_ply
from rtnr_tpu_torch.models.convert import init_unet_numpy
from rtnr_tpu_torch.pipeline import Renderer
from rtnr_tpu_torch.scene import Scene
from rtnr_tpu_torch.utils.checkpoint import save_msgpack
from rtnr_tpu_torch.utils.image import read_png, write_png
from torch_threads import one_thread  # noqa: F401 (autouse: torch on one thread)


@pytest.fixture
def fixture(tmp_path):
    """tests/test_cli.py's cloud (5000 points in front of the camera), 32x32
    matrix calibration and a 2-pose TUM trajectory."""
    rng = np.random.default_rng(1)
    n = 5000
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n), rng.uniform(4, 8, n)],
                   1).astype(np.float32)
    cols = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    cloud = tmp_path / "cloud.ply"
    write_ply(cloud, pts, cols)
    calib = tmp_path / "calib.txt"
    Camera.from_params(30, 30, 16, 16, 32, 32, (0, 0, 0, 0, 0)).save_calibration(calib)
    traj = tmp_path / "traj.txt"
    traj.write_text("0.0 0 0 0 0 0 0 1\n1.0 0.1 0 0 0 0 0 1\n")
    return tmp_path, [str(cloud), str(traj), str(calib)]


def _pngs(d):
    return {p.name: p.read_bytes() for p in sorted(d.glob("*.png"))}


@pytest.mark.parametrize("stage, extra", [
    ("project", ["--depth"]),
    ("filtered", ["--depth", "--timings"]),
    ("filtered", ["--cull-budget", "off", "--levels", "3", "--downsample", "0.5"]),
])
def test_cli_writes_the_jax_cli_pngs(fixture, capsys, stage, extra):
    tmp, files = fixture
    argv = ["--stage", stage, "--no-compile-cache"] + extra
    assert main(files + ["-o", str(tmp / "port")] + argv, device="cpu") == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert j_main(files + ["-o", str(tmp / "jax")] + argv) == 0
    jout = capsys.readouterr().out.strip().splitlines()
    got, want = _pngs(tmp / "port"), _pngs(tmp / "jax")
    names = ["frame_1.png", "frame_2.png"]
    if "--depth" in extra:
        names += ["frame_1_depth.png", "frame_2_depth.png"]
    assert sorted(got) == sorted(want) == sorted(names)
    for k in got:
        assert got[k] == want[k], k
    assert read_png(tmp / "port" / "frame_1.png").max() > 0
    # the same lines: a trajectory line, a cloud line, a frame line each, the JSON
    assert out[:2] == jout[:2] and len(out) == len(jout) == 5
    assert out[2].startswith("[1/2] frame_1.png  RENDER_TIME: projection[")
    rec, jrec = json.loads(out[-1]), json.loads(jout[-1])
    assert set(rec) == set(jrec) and rec["frames"] == 2 and rec["stage"] == stage


def test_cli_colmap_files_and_cache(fixture, capsys):
    """COLMAP cameras.txt + images.txt, a scene cache dir and a cache-dir
    cloud: the JAX CLI's PNGs."""
    tmp, (cloud, _, _) = fixture
    cams = tmp / "cameras.txt"
    cams.write_text("1 OPENCV 32 24 28 28 16 12 0 0 0 0 0\n")
    images = tmp / "images.txt"
    images.write_text("1 1 0 0 0 0.0 0.0 0.0 1 a.png\n\n2 0.99 0.1 0 0 0.2 0 0 1 b\n\n")
    argv = [str(images), str(cams), "--traj-format", "colmap", "--stage", "filtered",
            "--no-compile-cache"]
    cache = tmp / "cache"
    assert main([cloud] + argv + ["-o", str(tmp / "port"), "--cache-dir", str(cache)],
                device="cpu") == 0
    assert (cache / "pcd.npz").exists()
    assert main([str(cache)] + argv + ["-o", str(tmp / "port_cached")], device="cpu") == 0
    assert j_main([cloud] + argv + ["-o", str(tmp / "jax")]) == 0
    got, want = _pngs(tmp / "port"), _pngs(tmp / "jax")
    assert sorted(got) == ["a.png", "b.png"] and got == want == _pngs(tmp / "port_cached")
    (tmp / "empty").mkdir()
    assert main([str(tmp / "empty")] + argv, device="cpu") == 1  # a dir without a cache
    capsys.readouterr()


@pytest.mark.parametrize("ckpt", ["unet.msgpack", "model.pth.tar"])
def test_cli_full_stage_writes_compute_full(fixture, capsys, ckpt):
    tmp, files = fixture
    feats = (8, 16)
    raw = init_unet_numpy(0, feats)
    path = tmp / ckpt
    if ckpt.endswith(".msgpack"):
        save_msgpack(path, raw)
    else:
        from tests.test_unet import build_torch_unet
        from rtnr_tpu_torch.models.convert import load_torch_checkpoint

        torch.manual_seed(2)
        torch.save({"state_dict": build_torch_unet(features=feats).state_dict()}, path)
        raw = load_torch_checkpoint(str(path), feats)
    argv = files + ["-o", str(tmp / "out"), "--stage", "full", "--ckpt", str(path),
                    "--features", "8", "16", "--levels", "2", "--depth", "--timings"]
    assert main(argv, device="cpu") == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert "unet[" in out[2] and json.loads(out[-1])["stage"] == "full"
    cam = Camera.load_calibration(files[2])
    traj = Trajectory.load(files[1])
    r = Renderer(Scene.from_file(files[0]), RenderConfig(unet_features=feats, pyramid_levels=2),
                 raw, cull_budget="auto", device="cpu")
    for i in range(len(traj)):
        frame = r.compute_full(cam, traj.world_to_cam(i))
        want = tmp / f"want_{i}.png"
        write_png(want, frame["rgb"])
        assert (tmp / "out" / f"frame_{i + 1}.png").read_bytes() == want.read_bytes()
        assert (tmp / "out" / f"frame_{i + 1}_depth.png").exists()


@pytest.mark.parametrize("argv, msg", [
    (["--tiles", "2"], "needs 2 ranks"),
    (["--stage", "full"], "requires --ckpt"),
])
def test_cli_refuses_what_is_not_there(fixture, capsys, argv, msg):
    tmp, files = fixture
    assert main(files + ["-o", str(tmp / "out")] + argv, device="cpu") == 1
    assert msg in capsys.readouterr().err


def test_cli_batch_in_one_process_writes_the_serial_pngs(fixture, capsys):
    """--batch without a launcher: one rank renders the batch (2 poses
    padded to 3) and writes the serial CLI's PNGs; the closing line names
    the batch."""
    tmp, files = fixture
    argv = ["--stage", "filtered", "--depth"]
    assert main(files + ["-o", str(tmp / "batch"), "--batch", "3"] + argv, device="cpu") == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["batch"] == 3 and rec["ranks"] == 1 and rec["frames"] == 2
    assert main(files + ["-o", str(tmp / "serial")] + argv, device="cpu") == 0
    got, want = _pngs(tmp / "batch"), _pngs(tmp / "serial")
    assert len(got) == 4 and got == want


def test_cli_defaults_to_the_card_and_raises_without_it(fixture):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tmp, files = fixture
    with pytest.raises(RuntimeError, match="CUDA"):
        main(files + ["-o", str(tmp / "out")])
