"""The port's training-pair module (``rtnr_tpu_torch.data.pairs``) on the
CPU against the JAX package's ``rtnr_tpu.data.pairs``: ``generate_pairs``
and ``synthetic_pairs`` render the same depth and projected RGB bit for bit,
and ``batches_for_training`` yields the same arrays; the E57 route is
tested in ``test_torch_generate_pairs.py``."""

import numpy as np
import pytest

from rtnr_tpu.camera import Camera as JCamera
from rtnr_tpu.data import pairs as jpairs
from rtnr_tpu.scene import Scene as JScene
from rtnr_tpu_torch.camera import Camera
from rtnr_tpu_torch.data import pairs
from rtnr_tpu_torch.scene import Scene
from torch_threads import one_thread  # noqa: F401 (autouse: torch on one thread)

W, H = 32, 24
INTR = (30.0, 30.0, W / 2, H / 2, W, H)


@pytest.fixture(scope="module")
def scenes():
    rng = np.random.default_rng(8)
    n = 4000
    pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(-2, 2, n)],
                   1).astype(np.float32)
    cols = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    return Scene.from_arrays(pts, cols), JScene.from_arrays(pts, cols)


def _poses():
    out = []
    for k in range(3):
        E = np.eye(4)
        E[0, 3], E[2, 3] = 0.2 * k, 8.0 + 0.5 * k
        out.append(E)
    return out


def _same_pairs(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in ("image", "depth", "proj_rgb", "world_to_cam"):
            a, b = getattr(g, f), np.asarray(getattr(w, f))
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        assert (g.camera.width, g.camera.height) == (w.camera.width, w.camera.height)


@pytest.fixture(scope="module")
def made(scenes):
    """The same pairs from both packages: (port, JAX) for generate_pairs and
    synthetic_pairs."""
    port_scene, jax_scene = scenes
    images = [np.random.default_rng(9 + k).integers(0, 256, (H, W, 3), dtype=np.uint8)
              for k in range(3)]
    cams = [Camera.from_params(*INTR) for _ in range(3)]
    jcams = [JCamera.from_params(*INTR) for _ in range(3)]
    return {
        "generate": (pairs.generate_pairs(port_scene, images, _poses(), cams, device="cpu"),
                     jpairs.generate_pairs(jax_scene, images, _poses(), jcams)),
        "synthetic": (pairs.synthetic_pairs(port_scene, cams[0], n=3, seed=4,
                                            base_distance=8.0, device="cpu"),
                      jpairs.synthetic_pairs(jax_scene, jcams[0], n=3, seed=4,
                                             base_distance=8.0)),
    }


@pytest.mark.parametrize("kind", ["generate", "synthetic"])
def test_pairs_equal_jax(made, kind):
    got, want = made[kind]
    _same_pairs(got, want)
    assert all((p.depth < 3e38).any() for p in got)  # the poses see the cloud


@pytest.mark.parametrize("batch, seed", [(1, 0), (2, 0), (2, None), (3, 7)])
def test_batches_for_training_equal_jax(made, batch, seed):
    port, jax_pairs = made["generate"]
    got = list(pairs.batches_for_training(port, batch, shuffle_seed=seed))
    want = list(jpairs.batches_for_training(jax_pairs, batch, shuffle_seed=seed))
    assert len(got) == len(want) == 3 // batch
    for (gp, gt), (wp, wt) in zip(got, want):
        assert gp.dtype == wp.dtype == gt.dtype == wt.dtype == np.float32
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gt, wt)


def test_pairs_default_to_the_card(scenes):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        pairs.synthetic_pairs(scenes[0], Camera.from_params(*INTR), n=1)


def test_e57_pairs_name_the_missing_decoder(tmp_path):
    """A scan the E57 container decoder cannot open names the file and the
    decoder's reason (the decoder itself is no longer missing)."""
    with pytest.raises(ValueError, match="cannot open E57 file .*scan.e57: cannot open file"):
        pairs.generate_pairs_from_e57(tmp_path / "scan.e57")
