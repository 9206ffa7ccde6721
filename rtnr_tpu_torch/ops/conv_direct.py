"""Direct 3x3 conv (K10) on the K3 kernels.

Counterpart of ``rtnr_tpu/ops/conv_pallas.py`` (``_conv_kernel``, wrappers
``conv3x3_planar`` and ``conv3x3_pallas``): a 3x3 stride-1 same conv over
one input or the virtual channel concat of two, with the weights and the
bias rounded to bf16 (``conv_pallas.py:252, 258``), f32 sums, the bias and
ReLU in f32 and one bf16 rounding of the output. Those are exactly the
numerics of K3's exact bf16 mode (``ops/conv.py``), which also reads two
inputs without building the concat, so K10 runs on K3's CUDA kernels
through a wrapper with K10's signature: ``conv.takes_wgmma`` sends channel
counts and F that are multiples of 64 to the TMA + wgmma kernel
(``csrc/conv_sm90.cu``) and other shapes to ``csrc/conv.cu``'s bf16 GEMM.

The TPU's planar layout (``to_planar``, ``from_planar``,
``conv3x3_planar``: channels on sublanes, x on lanes, to fill the MXU) is a
TPU layout and is not ported; the port is NHWC throughout.

``conv3x3_pallas`` launches K3 for CUDA tensors and runs K3's plain twin
(``conv.conv3x3_plain`` numerics) only for CPU tensors;
``conv3x3_pallas.launches`` counts K3 launches made through it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from rtnr_tpu_torch.ops import conv as cv


def conv3x3_pallas(xs: Sequence[torch.Tensor], kernel, bias: Optional[torch.Tensor] = None, *,
                   relu: bool = False) -> torch.Tensor:
    """3x3 s1 same conv over the channel concat of ``xs`` (one or two NHWC
    (N, H, W, Ci) tensors, cast to bf16 as the TPU wrapper casts them), flax
    kernel (3, 3, sumC, F), optional bias (F,), optional ReLU ->
    (N, H, W, F) bf16. Images of a batch run one at a time, as on the TPU."""
    xs = [x.to(torch.bfloat16) for x in xs]
    if len(xs) not in (1, 2):
        raise ValueError("conv3x3_pallas takes one or two inputs")
    dev = xs[0].device
    w = cv.prepare_conv3x3(kernel, bias, dev)
    outs = []
    for b in range(xs[0].shape[0]):
        (y,) = cv.conv3x3_prepared([x[b:b + 1].contiguous() for x in xs], w, relu=relu)
        outs.append(y)
        if dev.type == "cuda":
            conv3x3_pallas.launches += 1
    return outs[0] if len(outs) == 1 else torch.cat(outs, 0)


conv3x3_pallas.launches = 0
