"""Weights across packages: JAX/Flax U-Net variables -> the port's U-Net.

``from_flax_variables`` takes the JAX package's variables as nested numpy
dicts, raw (``params`` + ``batch_stats``, folded here) or already folded
(``params`` only), and returns the port's flat state ``{"down0/conv0/kernel":
array, ...}`` in Flax's own layouts, which the port's U-Net consumes as they
are:

- ``down{i}/conv{0,1}``, ``bottleneck/conv{0,1}``, ``updc{i}/conv{0,1}``:
  3x3 kernels (3, 3, C_in, F) HWIO plus the folded bias. ``updc{i}/conv0``
  reads its input channels ordered ``[skip, up]`` (rtnr_tpu/models/unet.py:204,
  :514), which is the order ``conv3x3`` concatenates its two inputs in.
- ``up{i}``: ConvTranspose kernel (2, 2, C_in, F) with Flax's spatially
  flipped meaning (output subpixel (dy, dx) reads ``kernel[1-dy, 1-dx]``,
  rtnr_tpu/ops/conv_phase.py:1259-1262) plus bias.
- ``final_conv``: 1x1 head kernel (1, 1, F0, out) plus bias.

``init_unet_numpy`` makes seeded random raw variables (numpy only) at any
width, for the chip check and tests.

``convert_state_dict`` / ``load_torch_checkpoint`` read the reference's
torch ``model.pth.tar`` (reference model/model.py:21-45, export_pt.py:6-8)
into the same nested numpy variables as the JAX package's converter
(``rtnr_tpu/models/convert.py:29-101``): Conv2d ``(O,I,kh,kw)`` ->
``(kh,kw,I,O)``, ConvTranspose2d ``(I,O,kh,kw)`` -> ``(kh,kw,I,O)`` flipped
in space, BatchNorm as ``bn{j}`` scale/bias plus mean/var statistics.

For training, ``train_state_from_flax`` turns raw variables into the
trainable ``UNetTrain`` (same leaves, keyed by their tree paths), and
``to_flax_variables`` turns it back into the same nested numpy tree, which
JAX's ``UNet.apply`` and ``from_flax_variables`` (folding, for the serving
``UNet`` on K3/K4) both accept.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Optional, Sequence

import numpy as np

from rtnr_tpu_torch.models.fold_bn import fold_batchnorm


def unet_layer_names(n_levels: int):
    """(3x3 conv names, ConvTranspose names) in forward order."""
    convs = []
    for i in range(n_levels):
        convs += [f"down{i}/conv0", f"down{i}/conv1"]
    convs += ["bottleneck/conv0", "bottleneck/conv1"]
    ups = []
    for i in range(n_levels):
        ups.append(f"up{i}")
        convs += [f"updc{i}/conv0", f"updc{i}/conv1"]
    return convs, ups


def from_flax_variables(variables: Dict) -> Dict[str, np.ndarray]:
    """Flax U-Net variables (nested numpy dicts) -> flat f32 state."""
    if "batch_stats" in variables:
        variables = fold_batchnorm(variables)
    params = variables["params"]
    n_levels = sum(1 for k in params if k.startswith("down"))
    convs, ups = unet_layer_names(n_levels)
    state: Dict[str, np.ndarray] = {}
    for name in convs:
        block, conv = name.split("/")
        p = params[block][conv]
        if "bias" not in p:
            raise ValueError(f"{name} has no bias: pass raw variables with batch_stats "
                             "or variables already folded")
        state[f"{name}/kernel"] = np.asarray(p["kernel"], np.float32)
        state[f"{name}/bias"] = np.asarray(p["bias"], np.float32)
    for name in ups + ["final_conv"]:
        state[f"{name}/kernel"] = np.asarray(params[name]["kernel"], np.float32)
        state[f"{name}/bias"] = np.asarray(params[name]["bias"], np.float32)
    return state


def _conv_w(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _convT_w(w: np.ndarray) -> np.ndarray:
    # (I, O, kh, kw) -> (kh, kw, I, O) with spatial flip
    return np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1))[::-1, ::-1])


def _double_conv(sd: Mapping[str, np.ndarray], prefix: str) -> Dict:
    params, stats = {}, {}
    for j, (ci, bi) in enumerate(((0, 1), (3, 4))):
        params[f"conv{j}"] = {"kernel": _conv_w(np.asarray(sd[f"{prefix}.conv.{ci}.weight"]))}
        params[f"bn{j}"] = {
            "scale": np.asarray(sd[f"{prefix}.conv.{bi}.weight"]),
            "bias": np.asarray(sd[f"{prefix}.conv.{bi}.bias"]),
        }
        stats[f"bn{j}"] = {
            "mean": np.asarray(sd[f"{prefix}.conv.{bi}.running_mean"]),
            "var": np.asarray(sd[f"{prefix}.conv.{bi}.running_var"]),
        }
    return {"params": params, "batch_stats": stats}


def convert_state_dict(
    sd: Mapping[str, np.ndarray], features: Sequence[int] = (64, 128, 256, 512)
) -> Dict:
    """Map a torch UNet state dict (arrays as numpy) to the raw variables
    (``params`` + ``batch_stats``) in the Flax tree layout."""
    sd = {k: np.asarray(v, dtype=np.float32) for k, v in sd.items()}
    params: Dict = {}
    stats: Dict = {}

    for i in range(len(features)):
        dc = _double_conv(sd, f"downs.{i}")
        params[f"down{i}"] = dc["params"]
        stats[f"down{i}"] = dc["batch_stats"]

    dc = _double_conv(sd, "bottleneck")
    params["bottleneck"] = dc["params"]
    stats["bottleneck"] = dc["batch_stats"]

    for k in range(len(features)):
        params[f"up{k}"] = {
            "kernel": _convT_w(sd[f"ups.{2 * k}.weight"]),
            "bias": np.asarray(sd[f"ups.{2 * k}.bias"]),
        }
        dc = _double_conv(sd, f"ups.{2 * k + 1}")
        params[f"updc{k}"] = dc["params"]
        stats[f"updc{k}"] = dc["batch_stats"]

    params["final_conv"] = {
        "kernel": _conv_w(sd["final_conv.weight"]),
        "bias": np.asarray(sd["final_conv.bias"]),
    }
    return {"params": params, "batch_stats": stats}


def load_torch_checkpoint(path: str, features: Sequence[int] = (64, 128, 256, 512)) -> Dict:
    """Load a .pth/.pth.tar state dict with ``torch.load`` on the CPU and
    convert it. Accepts a bare state dict or one under the wrapper keys
    ``state_dict``, ``model`` or ``model_state_dict``."""
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and not any(k.startswith("downs.") for k in obj):
        for key in ("state_dict", "model", "model_state_dict"):
            if key in obj:
                obj = obj[key]
                break
    sd = {k: v.detach().cpu().numpy() for k, v in obj.items() if hasattr(v, "detach")}
    return convert_state_dict(sd, features)


def init_unet_numpy(
    seed: int,
    features: Sequence[int] = (64, 128, 256, 512),
    in_channels: int = 5,
    out_channels: int = 3,
) -> Dict:
    """Seeded random RAW variables in the Flax tree layout (He-normal convs,
    random BN statistics), numpy only."""
    rng = np.random.default_rng(seed)

    def he(shape):
        fan_in = int(np.prod(shape[:-1]))
        return (rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)

    def vec(lo, hi, n):
        return rng.uniform(lo, hi, n).astype(np.float32)

    params: Dict = {}
    stats: Dict = {}

    def double_conv(name, cin, f):
        params[name], stats[name] = {}, {}
        for j, c in enumerate((cin, f)):
            params[name][f"conv{j}"] = {"kernel": he((3, 3, c, f))}
            params[name][f"bn{j}"] = {"scale": vec(0.8, 1.2, f),
                                      "bias": (rng.standard_normal(f) * 0.05).astype(np.float32)}
            stats[name][f"bn{j}"] = {"mean": (rng.standard_normal(f) * 0.05).astype(np.float32),
                                     "var": vec(0.8, 1.2, f)}

    cin = in_channels
    for i, f in enumerate(features):
        double_conv(f"down{i}", cin, f)
        cin = f
    double_conv("bottleneck", cin, features[-1] * 2)
    cin = features[-1] * 2
    for i, f in enumerate(reversed(features)):
        params[f"up{i}"] = {"kernel": he((2, 2, cin, f)) * np.float32(0.5),
                            "bias": (rng.standard_normal(f) * 0.05).astype(np.float32)}
        double_conv(f"updc{i}", 2 * f, f)
        cin = f
    params["final_conv"] = {"kernel": he((1, 1, features[0], out_channels)),
                            "bias": (rng.standard_normal(out_channels) * 0.05).astype(np.float32)}
    return {"params": params, "batch_stats": stats}


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, f"{prefix}{k}/"))
        else:
            flat[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return flat


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def train_state_from_flax(variables: Dict, *, features: Optional[Sequence[int]] = None,
                          dtype=None):
    """Raw Flax U-Net variables (``params`` + ``batch_stats``, nested numpy
    or JAX arrays) -> ``UNetTrain`` on the CPU, f32 parameters. ``features``
    is read from the kernels and checked against the argument when given;
    ``dtype`` is the compute dtype (default float32)."""
    import torch

    from rtnr_tpu_torch.models.unet import UNetTrain

    params = variables["params"]
    n_levels = sum(1 for k in params if k.startswith("down"))
    found = tuple(int(np.shape(params[f"down{i}"]["conv0"]["kernel"])[-1])
                  for i in range(n_levels))
    if features is not None and tuple(features) != found:
        raise ValueError(f"features {tuple(features)} do not match the variables' {found}")
    return UNetTrain(_flatten(params), _flatten(variables["batch_stats"]), found,
                     torch.float32 if dtype is None else dtype)


def to_flax_variables(model) -> Dict:
    """``UNetTrain`` -> ``{"params": ..., "batch_stats": ...}``, nested dicts
    of f32 numpy arrays in the Flax tree layout."""

    def tree(named):
        return _unflatten({k.replace("__", "/"): t.detach().cpu().numpy().astype(np.float32)
                           for k, t in named})

    return {"params": tree(model.named_parameters()),
            "batch_stats": tree(model.named_buffers())}
