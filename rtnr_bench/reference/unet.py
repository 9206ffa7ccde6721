"""Plain reference of the serving U-Net in static integer quantisation.

The network is the reference's (EDM-Research model/model.py): encoder
DoubleConvs over ``features`` with 2x2 max-pools, a bottleneck at twice the
last width, decoder levels of a 2x2 stride-2 ConvTranspose and a DoubleConv
over ``[skip, up]``, a 1x1 head; BatchNorm folded into the convs.

Static quantisation on a grid of ``qmax`` steps (127: int8; 7: int4, the
control), written from the deployed int8 path's definition:

- calibration: one forward in exact bf16 (bf16 weights, biases, inputs and
  outputs, f32 sums) on the first view's input; each activation's scale is
  ``max(max|y|, 1e-8) * f32(1/qmax)``: every conv0 output, every conv1
  output before its pool except the last, every ConvTranspose output;
- the input conv: bf16 operands, the kernel and bias multiplied by
  ``1/s_out`` first, codes ``clip(rint(y), 0, qmax)``;
- every other conv and ConvTranspose: integer codes in, per-output-channel
  weight codes ``clip(rint(k / swv), -qmax, qmax)`` with ``swv =
  max(max|k|, 1e-12) * f32(1/qmax)`` (the up input's kernel slice of a
  decoder conv0 first multiplied by ``s_up / s_skip``), exact integer sums,
  ``y = f32(sum) * (swv * s_in * (1/s_out)) + bf16(bias / s_out)``, ReLU
  (none on the ConvTranspose, which clips at -qmax), codes at ``s_out``;
- the last conv writes bf16 (no ``s_out``), the head reads it: bf16 kernel
  and bias, f32 sums, bf16 out.

Integer sums are float64 GEMMs over the nine taps (exact below 2^53); f32
sums run with TF32 off. Rows go in blocks, so a 1080p frame fits beside
the scene.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as Fn

_BN_EPS = 1e-5
_ELEMS = 1 << 27  # elements of one block's tap operand


@contextlib.contextmanager
def no_tf32():
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


def fold(variables: Dict) -> Dict[str, np.ndarray]:
    """Raw variables -> flat folded f32 state ``{"down0/conv0/kernel": ...}``."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    flat = {}
    for name, p in params.items():
        if name in stats:
            for j in range(2):
                bn, st = p[f"bn{j}"], stats[name][f"bn{j}"]
                inv = np.asarray(bn["scale"], np.float32) / np.sqrt(
                    np.asarray(st["var"], np.float32) + _BN_EPS)
                flat[f"{name}/conv{j}/kernel"] = np.asarray(p[f"conv{j}"]["kernel"],
                                                            np.float32) * inv
                flat[f"{name}/conv{j}/bias"] = (np.asarray(bn["bias"], np.float32)
                                                - np.asarray(st["mean"], np.float32) * inv)
        else:
            flat[f"{name}/kernel"] = np.asarray(p["kernel"], np.float32)
            flat[f"{name}/bias"] = np.asarray(p["bias"], np.float32)
    return flat


def bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def conv_sums(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """3x3 same-padded conv sums of x (H, W, C) with w (3, 3, C, F) as
    (H*W, F) in ``dtype`` (float64: exact on integer codes)."""
    h, wd, c = x.shape
    f = w.shape[-1]
    xp = Fn.pad(x.to(dtype), (0, 0, 1, 1, 1, 1))
    wk = w.to(dtype).reshape(9, c, f)
    out = torch.empty((h * wd, f), dtype=dtype, device=x.device)
    rows = max(1, min(h, _ELEMS // (wd * c)))
    for r0 in range(0, h, rows):
        r1 = min(h, r0 + rows)
        acc = torch.zeros(((r1 - r0) * wd, f), dtype=dtype, device=x.device)
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            acc += xp[r0 + dy:r1 + dy, dx:dx + wd].reshape(-1, c) @ wk[tap]
        out[r0 * wd:r1 * wd] = acc
    return out


def _pool(y):
    h, w, f = y.shape
    return y.reshape(h // 2, 2, w // 2, 2, f).amax(dim=(1, 3))


def _up_layout(y4, h, w, f):
    """(h*w, 4, F) subpixel rows (dy*2 + dx) -> (2h, 2w, F)."""
    return y4.reshape(h, w, 2, 2, f).permute(0, 2, 1, 3, 4).reshape(2 * h, 2 * w, f)


def _convt_sums(x, k, dtype):
    """x (h, w, C), flax kernel k (2, 2, C, F) (subpixel (dy, dx) reads
    k[1-dy, 1-dx]) -> sums (h*w, 4, F)."""
    h, w, c = x.shape
    f = k.shape[-1]
    w4 = torch.flip(k, dims=(0, 1)).permute(2, 0, 1, 3).reshape(c, 4 * f)
    return (x.reshape(h * w, c).to(dtype) @ w4.to(dtype)).reshape(h * w, 4, f)


class RefUNet:
    """The folded net on ``device``; ``calibrate`` then ``forward``."""

    def __init__(self, variables: Dict, features: Sequence[int], device, qmax: int = 127):
        self.features = tuple(features)
        self.n = len(self.features)
        self.qmax = float(qmax)
        self.inv_q = float(np.float32(1.0 / qmax))
        self.p = {k: torch.from_numpy(v).to(device) for k, v in fold(variables).items()}

    # -- exact bf16 forward, recording the calibration maxima --
    def calibrate(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x (H, W, 5) f32 -> the static scales (0-d f32 tensors)."""
        seen: Dict[str, torch.Tensor] = {}
        p = self.p

        def conv(h, name, last=False):
            y = conv_sums(h, bf16(p[f"{name}/kernel"]), torch.float32) + bf16(p[f"{name}/bias"])
            y = bf16(torch.clamp(y, min=0.0)).reshape(h.shape[0], h.shape[1], -1)
            block, layer = name.split("/")
            if not last:
                seen[f"{block}/c{layer[-1]}"] = y.abs().amax()
            return y

        with torch.no_grad(), no_tf32():
            h = bf16(x)
            skips = []
            for i in range(self.n):
                y = conv(h, f"down{i}/conv0")
                y = conv(y, f"down{i}/conv1")
                skips.append(y)
                h = _pool(y)
            h = conv(conv(h, "bottleneck/conv0"), "bottleneck/conv1")
            for i in range(self.n):
                hh, ww, _ = h.shape
                k = p[f"up{i}/kernel"]
                up = _up_layout(_convt_sums(h, bf16(k), torch.float32) + bf16(p[f"up{i}/bias"]),
                                hh, ww, k.shape[-1])
                up = bf16(up)
                seen[f"u{i}t"] = up.abs().amax()
                y = conv(torch.cat([skips[-(i + 1)], up], -1), f"updc{i}/conv0")
                h = conv(y, f"updc{i}/conv1", last=i == self.n - 1)
        return {k: torch.clamp_min(m, 1e-8) * self.inv_q for k, m in seen.items()}

    # -- the quantised forward --
    def _codes(self, y, relu=True):
        return torch.clamp(torch.round(y), 0.0 if relu else -self.qmax, self.qmax)

    def _wquant(self, kf):
        swv = torch.clamp_min(kf.abs().amax(dim=tuple(range(kf.dim() - 1))), 1e-12) * self.inv_q
        return swv, torch.clamp(torch.round(torch.div(kf, swv)), -self.qmax, self.qmax)

    def _static_conv(self, xs: List[torch.Tensor], name: str, s_in: List[torch.Tensor],
                     s_out: Optional[torch.Tensor]):
        k, b = self.p[f"{name}/kernel"], self.p[f"{name}/bias"]
        if len(xs) == 2:
            c0 = xs[0].shape[-1]
            k = torch.cat([k[:, :, :c0], k[:, :, c0:] * torch.div(s_in[1], s_in[0])], dim=2)
        swv, wq = self._wquant(k)
        sw = swv * s_in[0]
        if s_out is not None:
            inv = torch.div(torch.ones_like(s_out), s_out)
            sw, b = sw * inv, b * inv
        x = torch.cat(xs, -1)
        h, w, _ = x.shape
        y = conv_sums(x, wq, torch.float64).to(torch.float32) * sw + bf16(b)
        y = torch.clamp(y, min=0.0).reshape(h, w, -1)
        return self._codes(y) if s_out is not None else bf16(y)

    def forward(self, x: torch.Tensor, s: Dict[str, torch.Tensor]) -> torch.Tensor:
        """x (H, W, 5) f32 -> (H, W, out) f32 holding bf16 values."""
        p, n = self.p, self.n
        with torch.no_grad(), no_tf32():
            inv = torch.div(torch.ones_like(s["down0/c0"]), s["down0/c0"])
            k0, b0 = bf16(p["down0/conv0/kernel"] * inv), bf16(p["down0/conv0/bias"] * inv)
            h_, w_, _ = x.shape
            y = conv_sums(bf16(x), k0, torch.float32) + b0
            h = self._codes(torch.clamp(y, min=0.0)).reshape(h_, w_, -1)
            skips = []
            for i in range(n):
                if i:
                    h = self._static_conv([h], f"down{i}/conv0", [s[f"down{i - 1}/c1"]],
                                          s[f"down{i}/c0"])
                y = self._static_conv([h], f"down{i}/conv1", [s[f"down{i}/c0"]],
                                      s[f"down{i}/c1"])
                skips.append(y)
                h = _pool(y)
            h = self._static_conv([h], "bottleneck/conv0", [s[f"down{n - 1}/c1"]],
                                  s["bottleneck/c0"])
            h = self._static_conv([h], "bottleneck/conv1", [s["bottleneck/c0"]],
                                  s["bottleneck/c1"])
            for i in range(n):
                prev = "bottleneck/c1" if i == 0 else f"updc{i - 1}/c1"
                k, b = p[f"up{i}/kernel"], p[f"up{i}/bias"]
                swv, wq = self._wquant(torch.flip(k, dims=(0, 1)))
                inv = torch.div(torch.ones_like(s[f"u{i}t"]), s[f"u{i}t"])
                sw, bb = swv * s[prev] * inv, bf16(b * inv)
                hh, ww, _ = h.shape
                acc = _convt_sums(h, torch.flip(wq, dims=(0, 1)), torch.float64)
                up = _up_layout(self._codes(acc.to(torch.float32) * sw + bb, relu=False),
                                hh, ww, k.shape[-1])
                skip = skips[-(i + 1)]
                y = self._static_conv([skip, up], f"updc{i}/conv0",
                                      [s[f"down{n - 1 - i}/c1"], s[f"u{i}t"]], s[f"updc{i}/c0"])
                last = i == n - 1
                h = self._static_conv([y], f"updc{i}/conv1", [s[f"updc{i}/c0"]],
                                      None if last else s[f"updc{i}/c1"])
            hk = bf16(p["final_conv/kernel"][0, 0])
            return bf16(h @ hk + bf16(p["final_conv/bias"]))
