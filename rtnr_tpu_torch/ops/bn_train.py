"""BatchNorm in training mode fused with the ReLU after it, for ``UNetTrain``.

The math is flax 0.12's ``nn.BatchNorm(use_running_average=False,
momentum=0.9, epsilon=1e-5)`` as the JAX package trains it (``DoubleConv``,
``rtnr_tpu/models/unet.py:366-374``), followed by ReLU: statistics in f32
with ``var = E[x^2] - E[x]^2`` clipped at 0 (``use_fast_variance``),
``y = relu(round((x - mean) * (rsqrt(var + eps) * scale) + bias))`` with one
rounding to the input's dtype, and the running statistics updated in place
with momentum 0.9 and that same biased variance (``F.batch_norm`` would
store the unbiased one). ``x`` is a conv output (N, C, H, W) in bf16 or
f32, channels-last in memory, as ``UNetTrain`` keeps its activations.

``reduce`` sums a per-channel vector over the ranks that share the batch
(``UNetTrain.sync_batch_stats``: ``parallel.collectives.psum_autograd``);
None is this rank alone. The forward reduces ``[sum x, sum x^2, count]``;
the backward ``[sum g, sum g * (x - mean)]``, since the gradient of a sum
over ranks is the sum of the ranks' gradients. The kernels sum each frame
of the batch apart and add the frames in order, so with one frame a rank
the ranks' sums are the bits of one rank holding the whole batch.

- ``bn_relu_train``: the layer. On a CUDA tensor it is one
  ``torch.autograd.Function`` over the kernels of ``csrc/bn_train.cu``
  (their header gives the backward's formula, its bound and the design):
  forward, the channel sums (``rtnr_bn_stats``) then normalise + ReLU
  (``rtnr_bn_apply``, which also updates the running statistics); backward,
  the gradient's channel sums (``rtnr_bn_grad_sums``, which also writes
  ``dscale`` and ``dbias``) then ``dx`` (``rtnr_bn_grad_x``). It saves only
  ``x`` and the per-channel sums for the backward. On a CPU tensor it runs
  ``bn_relu_train_plain`` under autograd.
- ``bn_relu_train_plain``: the plain torch layer, autograd's own backward.
- ``batch_sums_plain``, ``bn_relu_apply_plain``, ``bn_relu_grad_sums_plain``
  and ``bn_relu_grad_x_plain``: the four kernels' twins on plain torch ops,
  in the sums' dtype (f32, or f64 for an f64 ``x``); the tests hold them
  against autograd of ``bn_relu_train_plain``. Given the same sums, the
  per-channel terms (``channel_terms``) and the per-element arithmetic of
  the twins and the kernels are the same ops in the same order.

Counters: ``bn_relu_train.launches`` (forward calls on the kernels) and
``bn_relu_train.backward_launches``; each forward on the kernels also adds
1 to the open record's ``bn.fused`` (``utils.trace.count``).
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

from rtnr_tpu_torch import _build
from rtnr_tpu_torch.utils import trace

EPS = 1e-5
MOMENTUM = 0.9  # flax convention: running = 0.9 * running + 0.1 * batch
_VEC = 8  # channels a thread of the kernels owns (16-byte loads of bf16)

_P = ctypes.c_void_p
_I = ctypes.c_int

Reduce = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _bind(lib: ctypes.CDLL) -> None:
    lib.rtnr_bn_blocks.argtypes = [_I, _I, _I, _I]
    lib.rtnr_bn_stats.argtypes = [_P, _I, _I, _I, _I, _I, _P, _P, _P]
    lib.rtnr_bn_apply.argtypes = [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P]
    lib.rtnr_bn_grad_sums.argtypes = [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                                      _P]
    lib.rtnr_bn_grad_x.argtypes = [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P]
    for fn in (lib.rtnr_bn_blocks, lib.rtnr_bn_stats, lib.rtnr_bn_apply, lib.rtnr_bn_grad_sums,
               lib.rtnr_bn_grad_x):
        fn.restype = _I


def _lib() -> ctypes.CDLL:
    return _build.load("bn_train", _bind)


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    """f32 for bf16 / f32 activations (the statistics' precision), f64 for f64."""
    return torch.promote_types(x.dtype, torch.float32)


# ---- the plain layer (CPU path) ----

def bn_relu_train_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                        mean_buf: torch.Tensor, var_buf: torch.Tensor,
                        reduce: Reduce = None) -> torch.Tensor:
    """The layer on plain torch ops (module doc); autograd differentiates it."""
    xf = x.to(_compute_dtype(x))
    if reduce is None:
        mean, sq = xf.mean(dim=(0, 2, 3)), (xf * xf).mean(dim=(0, 2, 3))
    else:
        c = xf.shape[1]
        count = torch.full((1,), float(xf.numel() // c), dtype=xf.dtype, device=xf.device)
        tot = reduce(torch.cat([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)), count]))
        mean, sq = tot[:c] / tot[-1], tot[c:2 * c] / tot[-1]
    var = torch.clamp(sq - mean * mean, min=0.0)
    with torch.no_grad():
        mean_buf.copy_(MOMENTUM * mean_buf + (1 - MOMENTUM) * mean)
        var_buf.copy_(MOMENTUM * var_buf + (1 - MOMENTUM) * var)
    mul = torch.rsqrt(var + EPS) * scale
    y = (xf - mean[:, None, None]) * mul[:, None, None] + bias[:, None, None]
    return torch.relu(y.to(x.dtype))


# ---- the kernels' twins ----

def batch_sums_plain(x: torch.Tensor) -> torch.Tensor:
    """``rtnr_bn_stats``' twin: ``[sum x, sum x^2, count]`` per channel, in
    the statistics' dtype."""
    xf = x.to(_compute_dtype(x))
    count = torch.full((1,), float(xf.numel() // xf.shape[1]), dtype=xf.dtype, device=xf.device)
    return torch.cat([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)), count])


def channel_terms(tot: torch.Tensor, scale: torch.Tensor):
    """(mean, vraw, rstd, mul) per channel from the (reduced) sums ``tot``,
    op for op as the kernels take them."""
    c = (tot.numel() - 1) // 2
    n = tot[-1]
    mean = tot[:c] / n
    sq = tot[c:2 * c] / n
    vraw = sq - mean * mean
    # a correctly rounded sqrt and division, as the kernels take rsqrt
    rstd = 1.0 / torch.sqrt(torch.clamp(vraw, min=0.0) + EPS)
    return mean, vraw, rstd, rstd * scale.to(tot.dtype)


def _normalised(x, tot, scale, bias):
    """(round((x - mean) * mul + bias) in the statistics' dtype, x - mean, terms)."""
    mean, vraw, rstd, mul = channel_terms(tot, scale)
    xc = x.to(tot.dtype) - mean[:, None, None]
    y = (xc * mul[:, None, None] + bias.to(tot.dtype)[:, None, None]).to(x.dtype).to(tot.dtype)
    return y, xc, (mean, vraw, rstd, mul)


def bn_relu_apply_plain(x: torch.Tensor, tot: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, mean_buf: Optional[torch.Tensor] = None,
                        var_buf: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``rtnr_bn_apply``'s twin: the output from the (reduced) sums ``tot``;
    given the running statistics, updates them in place."""
    y, _, (mean, vraw, _, _) = _normalised(x, tot, scale, bias)
    if mean_buf is not None:
        with torch.no_grad():
            mean_buf.copy_(MOMENTUM * mean_buf + (1 - MOMENTUM) * mean)
            var_buf.copy_(MOMENTUM * var_buf + (1 - MOMENTUM) * torch.clamp(vraw, min=0.0))
    return torch.relu(y).to(x.dtype)


def bn_relu_grad_sums_plain(dy: torch.Tensor, x: torch.Tensor, tot: torch.Tensor,
                            scale: torch.Tensor, bias: torch.Tensor):
    """``rtnr_bn_grad_sums``' twin: (``[sum g, sum g * (x - mean)]`` of
    these rows, dscale, dbias), with ``g`` the gradient where the forward's
    output is above 0."""
    y, xc, (_, _, rstd, _) = _normalised(x, tot, scale, bias)
    g = torch.where(y > 0, dy.to(tot.dtype), 0.0)
    sums = torch.cat([g.sum(dim=(0, 2, 3)), (g * xc).sum(dim=(0, 2, 3))])
    c = x.shape[1]
    return sums, sums[c:] * rstd, sums[:c].clone()


def bn_relu_grad_x_plain(dy: torch.Tensor, x: torch.Tensor, tot: torch.Tensor,
                         scale: torch.Tensor, bias: torch.Tensor,
                         gsums: torch.Tensor) -> torch.Tensor:
    """``rtnr_bn_grad_x``'s twin: dx in x's dtype from ``gsums``, the
    gradient's sums over every rank (``csrc/bn_train.cu``'s header)."""
    y, xc, (_, vraw, rstd, mul) = _normalised(x, tot, scale, bias)
    g = torch.where(y > 0, dy.to(tot.dtype), 0.0)
    c, n = x.shape[1], tot[-1]
    dv = torch.where(vraw >= 0, gsums[c:] * scale.to(tot.dtype) * (-0.5 * (rstd * rstd * rstd)),
                     0.0)
    a = -(mul * gsums[:c]) / n
    b = 2 * dv / n
    dx = g * mul[:, None, None] + a[:, None, None] + b[:, None, None] * xc
    return dx.to(x.dtype)


# ---- the kernels ----

def _vec(C: int, *ts: torch.Tensor) -> int:
    """1 where the kernels take 8 channels a thread: C % 8 == 0 and every
    activation pointer 16-byte aligned."""
    return int(C % _VEC == 0 and all(t.data_ptr() % 16 == 0 for t in ts))


def _check(x: torch.Tensor, *vecs: torch.Tensor) -> None:
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"bn_relu_train: the kernels take bf16 or f32 activations, got {x.dtype}")
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"bn_relu_train: x must be a non-empty (N, C, H, W), got {tuple(x.shape)}")
    c = x.shape[1]
    for v in vecs:
        if v.device != x.device or v.dtype != torch.float32 or v.shape != (c,) \
                or not v.is_contiguous():
            raise ValueError("bn_relu_train: scale, bias and the running statistics must be "
                             f"contiguous f32 ({c},) tensors on the activations' device")


class _BnRelu(torch.autograd.Function):
    """The layer on the kernels; ``x`` and the output are (N, H, W, C)
    contiguous."""

    @staticmethod
    def forward(ctx, x, scale, bias, mean_buf, var_buf, reduce):
        n, h, w, c = x.shape
        dev = x.device
        lib = _lib()
        stream = torch.cuda.current_stream(dev).cuda_stream
        bf16 = int(x.dtype == torch.bfloat16)
        y = torch.empty_like(x)
        vec = _vec(c, x, y)
        partial = torch.empty((lib.rtnr_bn_blocks(n, h * w, c, vec), 2 * c),
                              dtype=torch.float32, device=dev)
        tot = torch.empty(2 * c + 1, dtype=torch.float32, device=dev)
        _build.check(lib.rtnr_bn_stats(x.data_ptr(), n, h * w, c, bf16, vec, partial.data_ptr(),
                                       tot.data_ptr(), stream), "rtnr_bn_stats")
        if reduce is not None:
            tot = reduce(tot)
        _build.check(lib.rtnr_bn_apply(x.data_ptr(), n, h * w, c, bf16, vec, tot.data_ptr(),
                                       scale.data_ptr(), bias.data_ptr(), mean_buf.data_ptr(),
                                       var_buf.data_ptr(), y.data_ptr(), stream), "rtnr_bn_apply")
        ctx.save_for_backward(x, tot, scale, bias)
        ctx.reduce = reduce
        return y

    @staticmethod
    def backward(ctx, dy):
        x, tot, scale, bias = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        n, h, w, c = x.shape
        dev = x.device
        lib = _lib()
        stream = torch.cuda.current_stream(dev).cuda_stream
        bf16 = int(x.dtype == torch.bfloat16)
        dx = torch.empty_like(x)
        vec = _vec(c, x, dy, dx)
        partial = torch.empty((lib.rtnr_bn_blocks(n, h * w, c, vec), 2 * c),
                              dtype=torch.float32, device=dev)
        sums = torch.empty(2 * c, dtype=torch.float32, device=dev)
        dscale = torch.empty(c, dtype=torch.float32, device=dev)
        dbias = torch.empty(c, dtype=torch.float32, device=dev)
        _build.check(lib.rtnr_bn_grad_sums(x.data_ptr(), dy.data_ptr(), n, h * w, c, bf16, vec,
                                           tot.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                                           partial.data_ptr(), sums.data_ptr(),
                                           dscale.data_ptr(), dbias.data_ptr(), stream),
                     "rtnr_bn_grad_sums")
        gsums = sums if ctx.reduce is None else ctx.reduce(sums)
        _build.check(lib.rtnr_bn_grad_x(x.data_ptr(), dy.data_ptr(), n, h * w, c, bf16, vec,
                                        tot.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                                        gsums.data_ptr(), dx.data_ptr(), stream),
                     "rtnr_bn_grad_x")
        bn_relu_train.backward_launches += 1
        return dx, dscale, dbias, None, None, None


def bn_relu_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  mean_buf: torch.Tensor, var_buf: torch.Tensor,
                  reduce: Reduce = None) -> torch.Tensor:
    """BatchNorm (training mode) + ReLU of the conv output ``x`` (N, C, H,
    W), updating ``mean_buf`` / ``var_buf`` in place; the output has x's
    dtype and layout (module doc). CPU tensors run the plain layer."""
    if x.device.type == "cpu":
        return bn_relu_train_plain(x, scale, bias, mean_buf, var_buf, reduce)
    if x.device.type != "cuda":
        raise ValueError(f"bn_relu_train: no kernel for device {x.device}")
    _check(x, scale, bias, mean_buf, var_buf)
    xn = x.permute(0, 2, 3, 1)  # channels-last memory: no copy
    y = _BnRelu.apply(xn.contiguous(), scale, bias, mean_buf, var_buf, reduce)
    bn_relu_train.launches += 1
    trace.count("bn.fused")
    return y.permute(0, 3, 1, 2)


bn_relu_train.launches = 0
bn_relu_train.backward_launches = 0
