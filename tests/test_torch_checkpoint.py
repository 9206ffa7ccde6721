"""The port's checkpoint readers and writers against the JAX package's:
the msgpack codec against flax's (``rtnr_tpu.utils.checkpoint``), and
``load_unet_variables`` on a full-size reference ``model.pth.tar`` (written
here as tests/test_checkpoint.py:78-122 writes it) against JAX's
``load_torch_checkpoint``."""

import numpy as np
import pytest
import torch

import jax
from flax import serialization

from rtnr_tpu.models.convert import load_torch_checkpoint as j_load_torch
from rtnr_tpu.utils.checkpoint import load_msgpack as j_load_msgpack
from rtnr_tpu.utils.checkpoint import save_msgpack as j_save_msgpack
from rtnr_tpu_torch.models.convert import (
    convert_state_dict,
    from_flax_variables,
    init_unet_numpy,
    load_torch_checkpoint,
)
from rtnr_tpu_torch.models.unet import UNet
from rtnr_tpu_torch.utils import checkpoint as ck
from torch_threads import one_thread  # noqa: F401 (autouse: torch on one thread)


def _same_tree(a, b):
    pa = jax.tree_util.tree_leaves_with_path(a)
    pb = jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (p, x), (_, y) in zip(pa, pb):
        assert type(x) is type(y), p
        assert np.asarray(x).dtype == np.asarray(y).dtype and np.shape(x) == np.shape(y), p
        np.testing.assert_array_equal(x, y, err_msg=str(p))


@pytest.fixture(scope="module")
def jax_variables():
    """Raw U-Net variables in the Flax tree layout (what JAX's ``UNet.init``
    returns, as numpy)."""
    return init_unet_numpy(0, (4, 8))


def _odd_tree():
    rng = np.random.default_rng(0)
    return {"a": {"f32": rng.normal(size=(3, 4)).astype(np.float32),
                  "i16": np.arange(300, dtype=np.int16).reshape(3, 100),
                  "u8": np.arange(5, dtype=np.uint8), "empty": np.zeros((0, 3)),
                  "zero_d": np.ones((), np.float64), "f64": rng.normal(size=70_000)},
            "scalars": {"f32": np.float32(2.5), "i64": np.int64(-7), "bool": np.bool_(True)},
            "k" * 40: np.arange(3, dtype=np.int32)}


def test_port_reads_jax_msgpack_as_flax(tmp_path, jax_variables):
    f = tmp_path / "unet.msgpack"
    j_save_msgpack(f, jax_variables)
    _same_tree(ck.load_msgpack(f), serialization.msgpack_restore(f.read_bytes()))
    _same_tree(ck.load_unet_variables(f), j_load_msgpack(f))


@pytest.mark.parametrize("tree", ["unet", "odd"])
def test_port_writes_flax_bytes(tmp_path, jax_variables, tree):
    """The codec writes flax's bytes for a tree (numpy scalars as ext 3), and
    ``save_msgpack`` the JAX package's (scalars as 0-d arrays, ext 1)."""
    t = jax_variables if tree == "unet" else _odd_tree()
    assert ck.msgpack_serialize(t) == serialization.msgpack_serialize(t)
    f, g = tmp_path / "port.msgpack", tmp_path / "jax.msgpack"
    ck.save_msgpack(f, t)
    j_save_msgpack(g, t)
    assert f.read_bytes() == g.read_bytes()
    _same_tree(serialization.msgpack_restore(f.read_bytes()), ck.load_msgpack(f))
    flax_bytes = serialization.msgpack_serialize(t)
    _same_tree(ck.msgpack_restore(flax_bytes), serialization.msgpack_restore(flax_bytes))


def test_msgpack_plain_values_and_errors(tmp_path):
    t = {"ints": [0, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32, -33, -128, -129,
                  -32768, -32769, -2**31 - 1], "f": 1.5, "none": None, "t": True, "s": "y" * 300,
         "b": b"q" * 70_000, "nested": [[1, 2], {"x": 3}]}
    data = ck.msgpack_serialize(t)
    assert serialization.msgpack_restore(data) == t == ck.msgpack_restore(data)
    small = ck.msgpack_serialize({"a": {"b": np.arange(4.0)}, "c": [1, -200, "x"]})
    for cut in range(len(small)):  # every truncation is refused
        with pytest.raises(ValueError, match="truncated"):
            ck.msgpack_restore(small[:cut])
    with pytest.raises(ValueError, match="after"):
        ck.msgpack_restore(data + b"\x00")
    with pytest.raises(TypeError):
        ck.msgpack_serialize({"x": object()})
    with pytest.raises(ValueError, match="Orbax"):
        ck.load_unet_variables(tmp_path)


def test_msgpack_checkpoint_from_torch_leaves_renders(tmp_path):
    """``save_msgpack`` takes torch leaves; the file loads into the port's
    U-Net as the numpy variables do."""
    raw = init_unet_numpy(1, (8, 16))
    f = tmp_path / "t.msgpack"
    ck.save_msgpack(f, jax.tree.map(torch.from_numpy, raw))
    back = ck.load_unet_variables(f)
    _same_tree(back, raw)
    s1, s2 = from_flax_variables(back), from_flax_variables(raw)
    assert all(np.array_equal(s1[k], s2[k]) for k in s2)


@pytest.mark.parametrize("wrapper", ["state_dict", "model_state_dict", None])
def test_small_torch_checkpoint_matches_jax(tmp_path, wrapper):
    from tests.test_unet import build_torch_unet

    torch.manual_seed(1)
    sd = build_torch_unet(features=(8, 16)).state_dict()
    path = tmp_path / "model.pth"
    torch.save(sd if wrapper is None else {wrapper: sd, "epoch": 3}, path)
    _same_tree(load_torch_checkpoint(str(path), (8, 16)), j_load_torch(str(path), (8, 16)))
    _same_tree(convert_state_dict({k: v.numpy() for k, v in sd.items()}, (8, 16)),
               j_load_torch(str(path), (8, 16)))


def test_full_size_pth_tar_matches_jax(tmp_path):
    """A full-size [64,128,256,512] state dict (~31M parameters) wrapped as a
    training checkpoint (state_dict + optimizer + epoch): ``load_unet_variables``
    gives JAX's tree, and the port's f32 net on it matches the torch twin."""
    import torch.nn as tnn

    from tests.test_unet import build_torch_unet

    features = (64, 128, 256, 512)
    torch.manual_seed(0)
    tm = build_torch_unet(features=features).eval()
    with torch.no_grad():
        for mod in tm.modules():
            if isinstance(mod, tnn.BatchNorm2d):
                mod.running_mean.uniform_(-0.5, 0.5)
                mod.running_var.uniform_(0.5, 1.5)
    n_params = sum(p.numel() for k, p in tm.state_dict().items()
                   if "num_batches_tracked" not in k)
    opt = {"state": {0: {"exp_avg": torch.zeros(4)}}, "param_groups": []}
    path = tmp_path / "model.pth.tar"
    torch.save({"state_dict": tm.state_dict(), "optimizer": opt, "epoch": 123}, path)

    variables = ck.load_unet_variables(path)
    _same_tree(variables, j_load_torch(str(path), features))
    assert sum(int(np.prod(v.shape)) for v in jax.tree.leaves(variables)) == n_params

    x = np.random.default_rng(1).normal(0, 1, (1, 5, 32, 64)).astype(np.float32)
    with torch.no_grad():
        ref = tm(torch.from_numpy(x)).numpy()
        y = UNet(from_flax_variables(variables), features=features).forward_plain(
            torch.from_numpy(np.transpose(x, (0, 2, 3, 1)).copy()), torch.float32).numpy()
    np.testing.assert_allclose(np.transpose(y, (0, 3, 1, 2)), ref, rtol=2e-3, atol=5e-4)
