"""U-Net refinement network, inference forward (folded BatchNorm).

Counterpart of ``rtnr_tpu/models/unet.py`` (``UNet._phase_forward``, bf16
exact mode), with the reference's structure (reference model/model.py:5-69):
encoder DoubleConvs over ``features`` with a 2x2 max-pool, a bottleneck at
2x the last width, decoder levels of 2x2/s2 ConvTranspose + DoubleConv over
``[skip, up]``, and a final 1x1 conv. 5 channels in (RGB, mask, depth), 3 out.

As in ``_phase_forward``, the pool is fused into each encoder level's second
conv and the 1x1 head into the last conv; every 3x3 conv runs ``conv3x3``
(K3) and every up-sampling ``convt2x2`` (K4). Inputs are padded to a
multiple of 2**levels upstream (``pipeline.pyramid_pad_shape``), so skip and
up shapes always match and no bilinear resize is needed (asserted).

``forward`` is the bf16 kernel path; ``forward_plain`` is the plain torch
twin net (``dtype=float32`` is the f32 reference, ``bfloat16`` repeats the
kernels' rounding).

``UNetTrain`` is the un-folded net for training (``UNet.__call__`` with
BatchNorm, ``rtnr_tpu/models/unet.py:478-522``): plain ``F.conv2d`` /
``F.conv_transpose2d``, as the JAX package trains on XLA's own convs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as Fn
from torch import nn

from rtnr_tpu_torch.models.convert import unet_layer_names
from rtnr_tpu_torch.ops.conv import (
    conv3x3_plain,
    conv3x3_prepared,
    convt2x2_plain,
    convt2x2_prepared,
    prepare_conv3x3,
    prepare_convt2x2,
    prepare_head,
)


def _buf(name: str) -> str:
    return name.replace("/", "__")


class UNet(nn.Module):
    """Inference U-Net over a flat folded state (``models.convert``)."""

    def __init__(self, state: Dict[str, np.ndarray], features: Sequence[int] = (64, 128, 256, 512),
                 out_channels: int = 3):
        super().__init__()
        self.features = tuple(features)
        self.out_channels = out_channels
        self.conv_names, self.up_names = unet_layer_names(len(self.features))
        for name in self.conv_names + self.up_names + ["final_conv"]:
            for part in ("kernel", "bias"):
                key = f"{name}/{part}"
                self.register_buffer(_buf(key), torch.tensor(np.asarray(state[key], np.float32)))
        self._prepared: Optional[dict] = None

    def param(self, key: str) -> torch.Tensor:
        return getattr(self, _buf(key))

    def prepare(self) -> dict:
        """Lay the weights out for the kernels (bf16) once, on the buffers'
        device; re-done only if the module moved."""
        dev = self.param("final_conv/bias").device
        if self._prepared is None or self._prepared["device"] != dev:
            p = {"device": dev}
            for name in self.conv_names:
                p[name] = prepare_conv3x3(self.param(f"{name}/kernel"), self.param(f"{name}/bias"))
            for name in self.up_names:
                p[name] = prepare_convt2x2(self.param(f"{name}/kernel"), self.param(f"{name}/bias"))
            p["final_conv"] = prepare_head(self.param("final_conv/kernel"),
                                           self.param("final_conv/bias"))
            self._prepared = p
        return self._prepared

    def _run(self, x, conv, convt):
        n = len(self.features)
        skips = []
        h = x
        for i in range(n):
            (y,) = conv([h], f"down{i}/conv0")
            y, h = conv([y], f"down{i}/conv1", pool=True)
            skips.append(y)
        (y,) = conv([h], "bottleneck/conv0")
        (h,) = conv([y], "bottleneck/conv1")
        for i in range(n):
            up = convt(h, f"up{i}")
            skip = skips[-(i + 1)]
            assert up.shape[:3] == skip.shape[:3], (
                f"decoder level {i}: up {tuple(up.shape)} vs skip {tuple(skip.shape)}; "
                f"pad the input to a multiple of {1 << n}")
            (y,) = conv([skip, up], f"updc{i}/conv0")
            (h,) = conv([y], f"updc{i}/conv1", head=i == n - 1)
        return h

    def _check_input(self, x: torch.Tensor) -> None:
        m = 1 << len(self.features)
        if x.dim() != 4 or x.shape[0] != 1 or x.shape[1] % m or x.shape[2] % m:
            raise ValueError(f"U-Net input must be (1, H, W, C) with H, W multiples of {m}; "
                             f"got {tuple(x.shape)}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """bf16 forward on the K3/K4 kernels: (1,H,W,5) -> (1,H,W,out) bf16."""
        self._check_input(x)
        p = self.prepare()

        def conv(xs, name, pool=False, head=False):
            return conv3x3_prepared(xs, p[name], relu=True, pool=pool,
                                    head=p["final_conv"] if head else None)

        def convt(h, name):
            return convt2x2_prepared(h, p[name])

        return self._run(x.to(torch.bfloat16).contiguous(), conv, convt)

    def forward_plain(self, x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Plain torch twin net in ``dtype`` (float32: the f32 reference)."""
        self._check_input(x)

        def conv(xs, name, pool=False, head=False):
            kw = {}
            if head:
                kw = dict(head_kernel=self.param("final_conv/kernel"),
                          head_bias=self.param("final_conv/bias"))
            return conv3x3_plain(xs, self.param(f"{name}/kernel"), self.param(f"{name}/bias"),
                                 relu=True, pool=pool, dtype=dtype, **kw)

        def convt(h, name):
            return convt2x2_plain(h, self.param(f"{name}/kernel"), self.param(f"{name}/bias"),
                                  dtype=dtype)

        return self._run(x.to(dtype).contiguous(), conv, convt)


_BN_EPS = 1e-5
_BN_MOMENTUM = 0.9  # flax convention: running = 0.9 * running + 0.1 * batch


class UNetTrain(nn.Module):
    """Trainable U-Net with BatchNorm (the JAX package's ``UNet`` with
    ``fold_bn=False``), in the JAX package's layouts: NHWC in and out, flax
    kernels (3x3: (3,3,C,F); ConvTranspose: (2,2,C,F), flipped; head:
    (1,1,F0,out)) as ``nn.Parameter``s, BN ``scale``/``bias`` as parameters
    and ``mean``/``var`` as buffers. ``models.convert`` carries the weights
    across (``train_state_from_flax`` / ``to_flax_variables``).

    ``.train()`` uses batch statistics and updates the running ones, as
    flax's ``nn.BatchNorm(use_running_average=False, momentum=0.9,
    epsilon=1e-5)``; ``.eval()`` uses the running ones. BatchNorm follows
    flax 0.12, not ``F.batch_norm``: statistics in f32 with ``var = E[x^2] -
    E[x]^2`` clipped at 0 (``use_fast_variance``), and the running variance
    updated with that same biased variance (``F.batch_norm`` would store the
    unbiased one).

    ``dtype`` follows flax's ``dtype``: parameters stay f32; with bfloat16
    every conv runs in bf16 (inputs and kernels rounded), BatchNorm
    normalises in f32 and rounds its output to bf16. Skip and up-sampled
    tensors are concatenated ``[skip, up]`` (one conv over the concat, the
    same math as the JAX package's split conv); inputs must be padded to a
    multiple of 2**levels, so no bilinear resize arises.
    """

    def __init__(self, params: Dict[str, np.ndarray], stats: Dict[str, np.ndarray],
                 features: Sequence[int] = (64, 128, 256, 512),
                 dtype: torch.dtype = torch.float32):
        """``params`` / ``stats``: flax ``params`` / ``batch_stats`` leaves
        keyed by their tree path joined with "/" (``models.convert``)."""
        super().__init__()
        self.features = tuple(features)
        self.dtype = dtype
        for key, a in params.items():
            self.register_parameter(_buf(key), nn.Parameter(torch.tensor(np.asarray(a, np.float32))))
        for key, a in stats.items():
            self.register_buffer(_buf(key), torch.tensor(np.asarray(a, np.float32)))

    def param(self, key: str) -> torch.Tensor:
        return getattr(self, _buf(key))

    def _bn(self, x: torch.Tensor, name: str) -> torch.Tensor:
        mean_buf, var_buf = self.param(f"{name}/mean"), self.param(f"{name}/var")
        xf = x.to(torch.float32)
        if self.training:
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            with torch.no_grad():
                mean_buf.copy_(_BN_MOMENTUM * mean_buf + (1 - _BN_MOMENTUM) * mean)
                var_buf.copy_(_BN_MOMENTUM * var_buf + (1 - _BN_MOMENTUM) * var)
        else:
            mean, var = mean_buf, var_buf
        mul = torch.rsqrt(var + _BN_EPS) * self.param(f"{name}/scale")
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.param(f"{name}/bias")[:, None, None]
        return y.to(self.dtype)

    def _double_conv(self, block: str, xs: List[torch.Tensor]) -> torch.Tensor:
        x = xs[0] if len(xs) == 1 else torch.cat(xs, dim=1)
        for j in range(2):
            k = self.param(f"{block}/conv{j}/kernel").permute(3, 2, 0, 1).to(self.dtype)
            x = Fn.conv2d(x, k, padding=1)
            x = torch.relu(self._bn(x, f"{block}/bn{j}"))
        return x

    def _convt(self, name: str, x: torch.Tensor) -> torch.Tensor:
        # torch's transposed conv does not flip: its weight [c, f, dy, dx]
        # is flax's kernel[1-dy, 1-dx, c, f] (ops/conv.py convt2x2_plain)
        k = self.param(f"{name}/kernel")
        wt = torch.flip(k, dims=(0, 1)).permute(2, 3, 0, 1).to(self.dtype)
        return Fn.conv_transpose2d(x, wt, self.param(f"{name}/bias").to(self.dtype), stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N,H,W,5) -> (N,H,W,out) in ``dtype``; H, W multiples of 2**levels."""
        m = 1 << len(self.features)
        if x.dim() != 4 or x.shape[1] % m or x.shape[2] % m:
            raise ValueError(f"U-Net input must be (N, H, W, C) with H, W multiples of {m}; "
                             f"got {tuple(x.shape)}")
        n = len(self.features)
        # NHWC memory seen as NCHW (channels-last strides): no copy
        h = x.to(self.dtype).permute(0, 3, 1, 2)
        skips = []
        for i in range(n):
            h = self._double_conv(f"down{i}", [h])
            skips.append(h)
            h = Fn.max_pool2d(h, 2)
        h = self._double_conv("bottleneck", [h])
        for i in range(n):
            h = self._double_conv(f"updc{i}", [skips[-(i + 1)], self._convt(f"up{i}", h)])
        k = self.param("final_conv/kernel").permute(3, 2, 0, 1).to(self.dtype)
        y = Fn.conv2d(h, k, self.param("final_conv/bias").to(self.dtype))
        return y.permute(0, 2, 3, 1)
