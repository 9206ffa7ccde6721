"""U-Net variables made on the device from a seed.

Raw variables in the JAX package's Flax tree layout (``params`` and
``batch_stats``, nested dicts of f32 numpy arrays), which both the port's
``Renderer`` / ``create_train_state`` and the benchmark's reference take.
The distribution is ``init_unet_numpy``'s: He-normal 3x3 convs, the
ConvTranspose kernels at half that, BatchNorm scales and running variances
uniform in [0.8, 1.2], biases and running means normal at 0.05. All normal
draws come from one ``torch.randn`` call and all uniform ones from one
``torch.rand`` call on the device.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from rtnr_bench.scenes import generator


def _leaves(features: Sequence[int], in_channels: int, out_channels: int):
    """(path, shape, kind, scale): kind "n" draws normal * scale, "u" draws
    uniform in [0.8, 1.2]."""
    out: List[Tuple[Tuple[str, ...], Tuple[int, ...], str, float]] = []

    def he(path, shape, mult=1.0):
        out.append((path, shape, "n", mult * float(np.sqrt(2.0 / int(np.prod(shape[:-1]))))))

    def double_conv(name, cin, f):
        for j, c in enumerate((cin, f)):
            he(("params", name, f"conv{j}", "kernel"), (3, 3, c, f))
            out.append((("params", name, f"bn{j}", "scale"), (f,), "u", 0.0))
            out.append((("params", name, f"bn{j}", "bias"), (f,), "n", 0.05))
            out.append((("batch_stats", name, f"bn{j}", "mean"), (f,), "n", 0.05))
            out.append((("batch_stats", name, f"bn{j}", "var"), (f,), "u", 0.0))

    cin = in_channels
    for i, f in enumerate(features):
        double_conv(f"down{i}", cin, f)
        cin = f
    double_conv("bottleneck", cin, 2 * features[-1])
    cin = 2 * features[-1]
    for i, f in enumerate(reversed(features)):
        he(("params", f"up{i}", "kernel"), (2, 2, cin, f), 0.5)
        out.append((("params", f"up{i}", "bias"), (f,), "n", 0.05))
        double_conv(f"updc{i}", 2 * f, f)
        cin = f
    he(("params", "final_conv", "kernel"), (1, 1, features[0], out_channels))
    out.append((("params", "final_conv", "bias"), (out_channels,), "n", 0.05))
    return out


def unet_variables(seed: int, features: Sequence[int], device, in_channels: int = 5,
                   out_channels: int = 3) -> Dict:
    leaves = _leaves(tuple(features), in_channels, out_channels)
    size = {k: sum(int(np.prod(s)) for _, s, kk, _ in leaves if kk == k) for k in "nu"}
    g = generator(seed ^ 0x5EED_0F_0E16, device)
    draws = {"n": torch.randn(size["n"], generator=g, device=device).cpu().numpy(),
             "u": (0.8 + 0.4 * torch.rand(size["u"], generator=g, device=device)).cpu().numpy()}
    at = {"n": 0, "u": 0}
    tree: Dict = {}
    for path, shape, kind, scale in leaves:
        n = int(np.prod(shape))
        a = draws[kind][at[kind]:at[kind] + n].reshape(shape)
        at[kind] += n
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = (a * np.float32(scale) if kind == "n" else a).astype(np.float32)
    return tree

