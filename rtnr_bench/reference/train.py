"""Plain reference of the U-Net training step, in float32.

The trainable net (BatchNorm not folded) as the training CLI trains it:
3x3 convs without bias, each followed by BatchNorm in training mode and
ReLU (batch statistics in f32, ``var = E[x^2] - E[x]^2`` clipped at 0,
eps 1e-5; running statistics ``0.9 * running + 0.1 * batch`` with that
biased variance, as flax's BatchNorm), 2x2 max-pools, 2x2 stride-2
ConvTransposes with bias (flax's flipped kernel), the decoder convs over
``[skip, up]``, a 1x1 head with bias. The loss is the mean absolute error
over the frame's H x W x 3 outputs (the padded rows cut off), and the
optimizer Adam (b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias
corrected). Convs run with TF32 off.

``lowp=True`` is the control: every conv's input and kernel rounded to
float8 e4m3 with a per-tensor scale (``amax / 448``), the gradient passed
straight through.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as Fn

from rtnr_bench.reference.unet import no_tf32

_EPS = 1e-5
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


def flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _fp8(t: torch.Tensor) -> torch.Tensor:
    s = torch.clamp_min(t.detach().abs().amax(), 1e-30) / 448.0
    q = (t.detach() / s).clamp(-448.0, 448.0).to(torch.float8_e4m3fn).to(torch.float32) * s
    return t + (q - t).detach()


class RefTrainer:
    """Parameters, BatchNorm statistics and Adam moments on ``device``."""

    def __init__(self, variables: Dict, features: Sequence[int], device, lr: float,
                 lowp: bool = False):
        self.features = tuple(features)
        self.lr = float(lr)
        self.q = _fp8 if lowp else (lambda t: t)
        self.params = {k: torch.from_numpy(v).to(device).requires_grad_(True)
                       for k, v in flatten(variables["params"]).items()}
        self.stats = {k: torch.from_numpy(v).to(device)
                      for k, v in flatten(variables["batch_stats"]).items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.t = 0

    def _bn(self, x, name):
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            for key, val in (("mean", mean), ("var", var)):
                buf = self.stats[f"{name}/{key}"]
                buf.copy_(0.9 * buf + 0.1 * val)
        p = self.params
        mul = torch.rsqrt(var + _EPS) * p[f"{name}/scale"]
        return (x - mean[:, None, None]) * mul[:, None, None] + p[f"{name}/bias"][:, None, None]

    def _double(self, block, x):
        for j in range(2):
            k = self.params[f"{block}/conv{j}/kernel"].permute(3, 2, 0, 1)
            x = torch.relu(self._bn(Fn.conv2d(self.q(x), self.q(k), padding=1), f"{block}/bn{j}"))
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, H, W, 5) -> (N, H, W, out)."""
        p, n = self.params, len(self.features)
        h = x.permute(0, 3, 1, 2)
        skips = []
        for i in range(n):
            h = self._double(f"down{i}", h)
            skips.append(h)
            h = Fn.max_pool2d(h, 2)
        h = self._double("bottleneck", h)
        for i in range(n):
            wt = torch.flip(p[f"up{i}/kernel"], dims=(0, 1)).permute(2, 3, 0, 1)
            up = Fn.conv_transpose2d(self.q(h), self.q(wt), p[f"up{i}/bias"], stride=2)
            h = self._double(f"updc{i}", torch.cat([skips[-(i + 1)], up], dim=1))
        k = p["final_conv/kernel"].permute(3, 2, 0, 1)
        return Fn.conv2d(self.q(h), self.q(k), p["final_conv/bias"]).permute(0, 2, 3, 1)

    def step(self, x: torch.Tensor, target: torch.Tensor):
        """One Adam step on unet_input x (N, H', W', 5) against target (N, H,
        W, 3): (loss, the gradient of every parameter, the net's output)."""
        _, hh, ww, _ = target.shape
        with no_tf32():
            out = self.forward(x)
            loss = torch.mean(torch.abs(out[:, :hh, :ww] - target))
            grads = torch.autograd.grad(loss, list(self.params.values()))
        g = dict(zip(self.params, grads))
        self.t += 1
        c1, c2 = 1.0 - B1 ** self.t, 1.0 - B2 ** self.t
        with torch.no_grad():
            for k, p in self.params.items():
                self.m[k].mul_(B1).add_(g[k], alpha=1.0 - B1)
                self.v[k].mul_(B2).addcmul_(g[k], g[k], value=1.0 - B2)
                p -= self.lr * (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + ADAM_EPS)
        return float(loss.detach()), g, out.detach()


def norm_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keys: Sequence[str]) -> List[Tuple[float, str, float, float]]:
    """Per leaf, the gap between the two sides' norms over the reference's
    norm of that leaf: (gap, leaf, the program's norm, the reference's),
    the worst first. A leaf the program leaves unmoved, or moves double,
    reads 1."""
    out = []
    for k in keys:
        pn = float(torch.linalg.vector_norm(prog[k].double()))
        rn = float(torch.linalg.vector_norm(ref[k].double()))
        out.append((abs(pn - rn) / rn if rn > 0 else float("inf"), k, pn, rn))
    return sorted(out, reverse=True)


def rel_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The norm of the difference over the reference's norm."""
    d = prog.to(torch.float64) - ref.to(torch.float64)
    return float(torch.linalg.vector_norm(d) / torch.linalg.vector_norm(ref.to(torch.float64)))


def moving_leaves(grads: Dict[str, torch.Tensor]) -> List[str]:
    """Leaves whose reference gradient is not nought to rounding: norm at
    least a thousandth of the median leaf's."""
    n = {k: float(torch.linalg.vector_norm(g.double())) for k, g in grads.items()}
    med = float(np.median(list(n.values())))
    return [k for k, v in n.items() if v >= 1e-3 * med]
