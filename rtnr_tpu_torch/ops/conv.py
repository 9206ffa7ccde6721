"""U-Net convolutions: 3x3 conv (K3) and 2x2/s2 transposed conv (K4).

Counterpart of ``rtnr_tpu/ops/conv_phase.py``. The TPU's polyphase layout is
not carried over: tensors are NHWC (1, H, W, C), bf16 or int8 codes, at
every public function, as in the JAX package's NHWC API. The CUDA kernels
are in ``csrc/conv.cu``, ``csrc/conv_sm90.cu``, ``csrc/conv_i8_sm90.cu`` and
``csrc/conv_in_sm90.cu`` (their headers note what each replaces, its bound
and its design).

K3's exact bf16 mode has three kernels; ``k3_route`` decides which. The
U-Net's input conv (one input of 1-8 channels to F = 64, no pool, no head;
``takes_in_conv``), with bf16 output or with int8 output codes, runs
``conv_in_sm90.cu``'s kernel (RS-form wgmma, the bias folded in as a
weight row against a column of ones); ``conv3x3_in_plain`` contracts as it
walks K. A call with channel counts and F all multiples of 64 (every
other U-Net conv, and K10) runs the TMA + wgmma implicit GEMM of
``conv_sm90.cu`` with the pool and the head fused
(``conv3x3_wgmma_plain``). ``conv.cu``'s GEMM serves narrow nets and the
shapes no other route takes.

K4's bf16 mode runs ``conv_sm90.cu``'s ``convt2x2_wgmma`` where
``takes_convt_wgmma`` (C and F multiples of 64: every bf16 ConvTranspose of
the full-width net), else ``conv.cu``'s GEMM; ``convt2x2_wgmma_plain``
contracts as it walks.

The int8 modes the full-width net runs have s8 wgmma kernels in
``conv_i8_sm90.cu``: K3 dyn where ``takes_dyn_wgmma`` (channel counts
multiples of 64, F of 256, no head), K3 static where
``takes_static_wgmma`` (channel counts and F multiples of 64, the head only
at F = 64) and K4 static where
``takes_convt_i8_wgmma`` (C and F multiples of 64, int8 output); other
shapes (narrow nets, toy widths) stay on ``conv.cu``'s GEMM.
``conv3x3_dyn_wgmma_plain``, ``conv3x3_static_wgmma_plain`` and
``convt2x2_i8_wgmma_plain`` contract as those kernels walk N and K.

- ``conv3x3(xs, kernel, bias, *, relu, pool, head_kernel, head_bias, quant,
  in_scales, out_scale)``: 3x3 s1 same conv over the virtual concat of one
  or two inputs, bias, ReLU; ``pool`` adds the 2x2 max-pool of the output;
  ``head_kernel`` applies the 1x1 head to the (bf16) output instead of
  returning it. Returns a tuple like ``conv3x3_phase``: (out,),
  (out, pooled) or (head_out,).
- ``convt2x2(x, kernel, bias, *, quant, in_scale, out_scale)``: flax's 2x2
  stride-2 ConvTranspose (output subpixel (dy, dx) reads
  ``kernel[1-dy, 1-dx]``) plus bias.
- ``conv3x3(..., up_kernel=, up_bias=)``, K3's fused-ConvTranspose mode
  (``conv3x3_phase(up_kernel=)``, ``conv_phase.py:720-780``): ``xs =
  [skip, deep]`` with ``deep`` at half resolution; the conv runs over
  ``[skip, convt2x2(deep)]``, the up values rounded to bf16 once and the
  up pixels past the image the conv's zero padding. bf16 only, no pool, no
  head. On the card ``takes_up`` shapes (C_up == F in {64, 128}) run
  ``conv_sm90.cu``'s fused kernel, whose output equals the card's K4 then
  K3 bit for bit; any other shape runs that pair. ``fuse_up_ok`` is the JAX
  package's rule of which decoder levels fuse.

Modes, as ``conv3x3_phase(quant=, in_scales=, out_scale=)`` and
``convt2x2_phase`` (numerics of ``conv_phase.py:846-943, 1259-1290``):
- ``quant=""``, exact: weights and bias rounded to bf16, f32 accumulation,
  bias and ReLU in f32, one bf16 rounding of the output; the head reads the
  bf16 conv output. With ``out_scale`` (K3 only) the output is int8 codes
  ``clip(rint(y), 0 or -127, 127)`` at that scale: the f32 kernel and the
  bias are multiplied by ``1/out_scale`` before they are rounded to bf16.
- ``quant="static"``: int8 inputs at ``in_scales`` (one 0-d scale per
  input; K4: ``in_scale``). Per-output-channel weights ``swv =
  max(max|k|, 1e-12) * f32(1/127)``, ``Wq = clip(rint(k / swv), -127,
  127)``; a second input's slice of the kernel is first multiplied by
  ``s_in1 / s_in0``. i32 accumulation, ``y = f32(acc) * sw_eff + bias`` with
  ``sw_eff = swv * s_in0 * (1/out_scale)`` and the bias ``bf16(bias /
  out_scale)``; ReLU; int8 codes at ``out_scale``, or bf16 without it (the
  head conv). K4 has no ReLU and clips to [-127, 127].
- ``quant="dyn"`` (K3): bf16 inputs quantised to int8 per output pixel (the
  3x3 receptive field over all channels: ``inv = 127/amax``, ``q =
  clip(rint(x * inv), -127, 127)``), i32 accumulation, dequantised by
  ``swv * (amax * f32(1/127))``, bias, ReLU, bf16 out. The TPU groups per
  lane over its row window instead (see ``csrc/conv.cu``).

``prepare_conv3x3`` / ``prepare_convt2x2`` / ``prepare_head`` quantise and
lay the weights out once (the U-Net keeps them on the device); the scales
stay device tensors, so nothing returns to the host. The ``*_prepared``
wrappers launch the kernels for CUDA tensors and run the plain torch twins
(``*_prepared_plain``, the same function on int64-exact f64 sums) only for
CPU tensors. Launch counters: ``conv3x3.launches`` / ``convt2x2.launches``
(bf16 mode, either kernel), ``conv3x3_wgmma`` / ``convt2x2_wgmma`` (the
calls of those that ran ``conv_sm90.cu``), ``conv3x3_up`` (the
fused-ConvTranspose kernel; its calls count nowhere else),
``conv3x3_i8out``, ``conv3x3_static``, ``conv3x3_dyn`` and
``convt2x2_static`` (``.launches``, every call of the mode), and
``conv3x3_dyn_wgmma`` / ``conv3x3_static_wgmma`` / ``convt2x2_static_wgmma``
(the calls of those that ran ``conv_i8_sm90.cu``) and ``conv3x3_in`` (the
calls of ``conv3x3`` or ``conv3x3_i8out`` that ran ``conv_in_sm90.cu``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as Fn

from rtnr_tpu_torch import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
# K step of the GEMM kernel in elements (64 bytes): weight rows pad to a multiple
_BK = {torch.bfloat16: 32, torch.int8: 64}
_KIND = {"": 0, "static": 1, "dyn": 2}
# channels of one K step of conv_sm90.cu: C0, C1 and F must be multiples
_WG_CHUNK = 64
# output channels (K3 dyn) or GEMM columns (K4 static) of a conv_i8_sm90.cu tile
_I8_BN = 256
# the input conv of conv_in_sm90.cu: at most 8 input channels, F = 64 (the
# full-width net's features[0]), K walked in k16 steps
_IN_MAX_C = 8
_IN_F = 64
_IN_KSTEP = 16
# f32(1/127), the quantiser's constant (conv_phase.py:329, :870)
INV127 = float(np.float32(1.0 / 127.0))


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _bind(lib: ctypes.CDLL) -> None:
    lib.rtnr_conv3x3.argtypes = [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _P]
    lib.rtnr_convt2x2.argtypes = [_P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P]
    lib.rtnr_dyn_scales.argtypes = [_P, _P, _I, _I, _I, _I, _P, _P, _P]
    lib.rtnr_maxpool2.argtypes = [_P, _I, _I, _I, _I, _P, _P]
    lib.rtnr_head1x1.argtypes = [_P, _I, _I, _P, _P, _I, _P, _P]
    for fn in (lib.rtnr_conv3x3, lib.rtnr_convt2x2, lib.rtnr_dyn_scales, lib.rtnr_maxpool2,
               lib.rtnr_head1x1):
        fn.restype = _I


def _lib() -> ctypes.CDLL:
    return _build.load("conv", _bind)


def _bind_sm90(lib: ctypes.CDLL) -> None:
    lib.rtnr_conv3x3_wgmma.argtypes = [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P,
                                       _I, _I, _P]
    lib.rtnr_conv3x3_up_wgmma.argtypes = [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _P]
    lib.rtnr_convt2x2_wgmma.argtypes = [_P, _I, _I, _I, _P, _P, _P, _I, _P]
    for fn in (lib.rtnr_conv3x3_wgmma, lib.rtnr_conv3x3_up_wgmma, lib.rtnr_convt2x2_wgmma):
        fn.restype = _I


def _bind_in(lib: ctypes.CDLL) -> None:
    lib.rtnr_conv3x3_in.argtypes = [_P, _I, _I, _I, _P, _I, _P, _P, _I, _I, _P]
    lib.rtnr_conv3x3_in.restype = _I


def _bind_i8(lib: ctypes.CDLL) -> None:
    lib.rtnr_conv3x3_dyn_wgmma.argtypes = [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I,
                                           _I, _P]
    lib.rtnr_convt2x2_i8_wgmma.argtypes = [_P, _I, _I, _I, _P, _P, _P, _P, _I, _P]
    lib.rtnr_conv3x3_static_wgmma.argtypes = [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P,
                                              _P, _I, _P, _I, _I, _P]
    for fn in (lib.rtnr_conv3x3_dyn_wgmma, lib.rtnr_convt2x2_i8_wgmma,
               lib.rtnr_conv3x3_static_wgmma):
        fn.restype = _I


class LaunchCount:
    """Launch counter of one kernel mode: its wrapper adds one to
    ``launches`` per call that launches the mode's kernels."""

    def __init__(self) -> None:
        self.launches = 0


conv3x3_wgmma = LaunchCount()  # K3 exact bf16 on conv_sm90.cu (TMA + wgmma)
convt2x2_wgmma = LaunchCount()  # K4 bf16 on conv_sm90.cu
conv3x3_up = LaunchCount()  # K3's fused-ConvTranspose mode on conv_sm90.cu
conv3x3_i8out = LaunchCount()  # K3 exact bf16 GEMM with int8 output codes
conv3x3_static = LaunchCount()  # K3 static int8
conv3x3_dyn = LaunchCount()  # K3 dyn int8
convt2x2_static = LaunchCount()  # K4 static int8
conv3x3_dyn_wgmma = LaunchCount()  # K3 dyn int8 on conv_i8_sm90.cu (s8 wgmma)
convt2x2_static_wgmma = LaunchCount()  # K4 static int8 on conv_i8_sm90.cu
conv3x3_static_wgmma = LaunchCount()  # K3 static int8 on conv_i8_sm90.cu (s8 wgmma)
conv3x3_in = LaunchCount()  # the input conv (bf16 or int8 out) on conv_in_sm90.cu


def _as_tensor(a, device=None) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(a)
    return t.to(device=device, dtype=torch.float32)


def _scale(s, device) -> torch.Tensor:
    """A 0-d f32 scale on ``device``."""
    return _as_tensor(s, device).reshape(())


def _bf16_values(t: torch.Tensor) -> torch.Tensor:
    """f32 tensor holding the bf16 rounding of ``t``."""
    return t.to(torch.bfloat16).to(torch.float32)


def _inv(s: torch.Tensor) -> torch.Tensor:
    """1 / s, correctly rounded (``1.0 / t`` in torch multiplies by the
    reciprocal)."""
    return torch.div(torch.ones_like(s), s)


def _quant_weights(kf: torch.Tensor, dims):
    """Per-output-channel symmetric int8: (swv, Wq) over the last axis."""
    swv = torch.clamp_min(kf.abs().amax(dim=dims), 1e-12) * INV127
    return swv, torch.clamp(torch.round(torch.div(kf, swv)), -127.0, 127.0)


def _pad_rows(m: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    out = torch.zeros((_round_up(m.shape[0], _BK[dtype]), m.shape[1]), dtype=dtype,
                      device=m.device)
    out[: m.shape[0]] = m.to(dtype)
    return out.contiguous()


class Conv3x3Weights(NamedTuple):
    wmat: torch.Tensor  # (Kp, F) bf16 or int8: flax (3,3,C,F) reshaped, zero rows K..Kp-1
    bias: torch.Tensor  # (F,) f32 values of the bf16 bias (divided by out_scale)
    cin: int
    quant: str = ""  # "" | "static" | "dyn"
    scale: Optional[torch.Tensor] = None  # (F,) f32 dequantisation scale (int8 modes)
    out_i8: bool = False  # int8 output codes at out_scale
    # exact bf16 with cin and F multiples of 64: (F, 9*cin) bf16, the K-major
    # copy of wmat[:9*cin] that conv_sm90.cu reads; dyn with cin a multiple
    # of 64 and F of 256, and static with every input's channel count and F
    # multiples of 64: the same (F, 9*cin) int8 copy for conv_i8_sm90.cu
    wmat_t: Optional[torch.Tensor] = None


class ConvT2x2Weights(NamedTuple):
    wmat: torch.Tensor  # (Kp, 4F) bf16 or int8: column (dy*2+dx)*F + f = kernel[1-dy,1-dx,:,f]
    bias: torch.Tensor  # (F,) f32 values of the bf16 bias (divided by out_scale)
    cin: int
    f: int
    quant: str = ""  # "" | "static"
    scale: Optional[torch.Tensor] = None  # (F,) f32 dequantisation scale (static)
    out_i8: bool = False
    # bf16 with cin and F multiples of 64: (4F, cin) bf16, the K-major B of
    # K4's conv_sm90.cu kernel and of the fused kernel's up GEMM; row
    # (u*4 + dy*2 + dx)*64 + j holds
    # kernel[1-dy, 1-dx, :, 64u + j] (64 up channels a chunk u). Static with
    # cin and F multiples of 64: (4F, cin) int8, wmat[:cin] transposed (row
    # (dy*2 + dx)*F + f, the GEMM's column order), for conv_i8_sm90.cu
    wmat_t: Optional[torch.Tensor] = None


class HeadWeights(NamedTuple):
    hk: torch.Tensor  # (F, OC) bf16
    hb: torch.Tensor  # (OC,) f32 values of the bf16 bias
    # OC <= 8: (F, 8) bf16, hk zero-padded, one 16-byte row a channel (conv_sm90.cu)
    hk8: Optional[torch.Tensor] = None


def prepare_conv3x3(kernel, bias=None, device=None, *, quant: str = "", in_scales=None,
                    out_scale=None, c0: Optional[int] = None) -> Conv3x3Weights:
    """Weights of one K3 call in mode ``quant`` (module doc). Static mode
    with two inputs needs ``c0``, the channel count of input 0."""
    if quant not in _KIND:
        raise ValueError(f"unknown quant mode {quant!r}")
    k = _as_tensor(kernel, device)
    kh, kw, c, f = k.shape
    assert (kh, kw) == (3, 3)
    dev = k.device
    b = torch.zeros(f, device=dev) if bias is None else _as_tensor(bias, dev)
    inv_out = None
    if out_scale is not None:
        inv_out = _inv(_scale(out_scale, dev))
        b = b * inv_out
    if quant == "":
        if inv_out is not None:
            k = k * inv_out
        kmat = k.reshape(9 * c, f)
        wmat_t = None
        if inv_out is None and c % _WG_CHUNK == 0 and f % _WG_CHUNK == 0:
            wmat_t = kmat.t().to(torch.bfloat16).contiguous()
        return Conv3x3Weights(_pad_rows(kmat, torch.bfloat16), _bf16_values(b).contiguous(), c,
                              "", None, inv_out is not None, wmat_t)
    kf = k
    if quant == "static":
        if in_scales is None or len(in_scales) not in (1, 2):
            raise ValueError("static mode needs one input scale per input")
        s = [_scale(v, dev) for v in in_scales]
        if len(s) == 2:
            if c0 is None:
                raise ValueError("two static inputs need c0, input 0's channel count")
            kf = torch.cat([kf[:, :, :c0], kf[:, :, c0:] * torch.div(s[1], s[0])], dim=2)
    swv, wq = _quant_weights(kf, (0, 1, 2))
    sw_eff = swv * s[0] if quant == "static" else swv
    if inv_out is not None:
        sw_eff = sw_eff * inv_out
    wmat = _pad_rows(wq.reshape(9 * c, f), torch.int8)
    wmat_t = None
    cs = (c,) if quant == "dyn" or c0 is None or c0 == c else (c0, c - c0)
    if (takes_dyn_wgmma(cs, f) if quant == "dyn" else takes_static_wgmma(cs, f)):
        wmat_t = wmat[:9 * c].t().contiguous()
    return Conv3x3Weights(wmat, _bf16_values(b).contiguous(), c, quant, sw_eff.contiguous(),
                          inv_out is not None, wmat_t)


def prepare_convt2x2(kernel, bias=None, device=None, *, quant: str = "", in_scale=None,
                     out_scale=None) -> ConvT2x2Weights:
    """Weights of one K4 call: bf16 (``quant=""``) or static int8."""
    if quant not in ("", "static"):
        raise ValueError(f"K4 has modes '' and 'static', not {quant!r}")
    k = _as_tensor(kernel, device)
    kh, kw, c, f = k.shape
    assert (kh, kw) == (2, 2)
    dev = k.device
    # flax ConvTranspose applies the spatially flipped kernel
    w4 = torch.flip(k, dims=(0, 1))  # w4[dy, dx] = kernel[1-dy, 1-dx]
    b = torch.zeros(f, device=dev) if bias is None else _as_tensor(bias, dev)
    if quant == "":
        if out_scale is not None:
            raise ValueError("the bf16 K4 writes bf16; int8 output needs quant='static'")
        wmat = _pad_rows(w4.permute(2, 0, 1, 3).reshape(c, 4 * f), torch.bfloat16)
        wmat_t = None
        if c % _WG_CHUNK == 0 and f % _WG_CHUNK == 0:
            wmat_t = (w4.reshape(2, 2, c, f // _WG_CHUNK, _WG_CHUNK).permute(3, 0, 1, 4, 2)
                      .reshape(4 * f, c).to(torch.bfloat16).contiguous())
        return ConvT2x2Weights(wmat, _bf16_values(b).contiguous(), c, f, wmat_t=wmat_t)
    if in_scale is None:
        raise ValueError("static mode needs in_scale")
    swv, wq = _quant_weights(w4, (0, 1, 2))
    sw_eff = swv * _scale(in_scale, dev)
    if out_scale is not None:
        inv_out = _inv(_scale(out_scale, dev))
        sw_eff, b = sw_eff * inv_out, b * inv_out
    wmat = _pad_rows(wq.permute(2, 0, 1, 3).reshape(c, 4 * f), torch.int8)
    wmat_t = None
    if c % _WG_CHUNK == 0 and f % _WG_CHUNK == 0:
        wmat_t = wmat[:c].t().contiguous()
    return ConvT2x2Weights(wmat, _bf16_values(b).contiguous(), c, f, "static",
                           sw_eff.contiguous(), out_scale is not None, wmat_t)


def prepare_head(head_kernel, head_bias=None, device=None) -> HeadWeights:
    hk = _as_tensor(head_kernel, device)
    if hk.dim() == 4:  # flax (1, 1, F, OC)
        hk = hk[0, 0]
    oc = hk.shape[1]
    hb = torch.zeros(oc, device=hk.device) if head_bias is None else _as_tensor(head_bias, device)
    hk = hk.to(torch.bfloat16).contiguous()
    hk8 = None
    if oc <= 8:
        hk8 = torch.zeros((hk.shape[0], 8), dtype=torch.bfloat16, device=hk.device)
        hk8[:, :oc] = hk
    return HeadWeights(hk, _bf16_values(hb).contiguous(), hk8)


def takes_wgmma(cs: Sequence[int], f: int, *, quant: str = "", out_i8: bool = False,
                head: bool = False) -> bool:
    """Whether a K3 call on a CUDA tensor runs ``conv_sm90.cu`` (else
    ``conv.cu``'s GEMM): exact bf16 with bf16 output, every input's channel
    count and F multiples of 64, and with the head, F <= 128 (one output
    tile holds every channel; the head's OC <= 8 either way)."""
    return (quant == "" and not out_i8 and all(c % _WG_CHUNK == 0 for c in cs)
            and f % _WG_CHUNK == 0 and not (head and f > 128))


def takes_in_conv(cs: Sequence[int], f: int, *, quant: str = "", head: bool = False,
                  pool: bool = False) -> bool:
    """Whether a K3 call on a CUDA tensor runs ``conv_in_sm90.cu``: the
    U-Net's input conv, one input of 1-8 channels to F = 64 in the exact
    mode (bf16 output, or int8 codes with ``out_scale``), without the head
    or the pool."""
    return (len(cs) == 1 and 1 <= cs[0] <= _IN_MAX_C and f == _IN_F and quant == ""
            and not head and not pool)


def takes_dyn_wgmma(cs: Sequence[int], f: int, *, head: bool = False) -> bool:
    """Whether a dyn-mode K3 call on CUDA tensors runs ``conv_i8_sm90.cu``
    (else ``conv.cu``'s GEMM): every input's channel count a multiple of 64
    and F of 256 (one tile holds 256 output channels), without the head.
    Every dyn call of the full-width net qualifies (F in {256, 512, 1024})."""
    return all(c % _WG_CHUNK == 0 for c in cs) and f % _I8_BN == 0 and not head


def takes_static_wgmma(cs: Sequence[int], f: int, *, head: bool = False) -> bool:
    """Whether a static-mode K3 call on CUDA tensors runs ``conv_i8_sm90.cu``
    (else ``conv.cu``'s GEMM): every input's channel count and F multiples
    of 64 and, with the head, F = 64 (one consumer holds every channel of
    its pixels). Every static call of the full-width net qualifies (F in
    {64, ..., 1024}, the head conv at F = 64)."""
    return (all(c % _WG_CHUNK == 0 for c in cs) and f % _WG_CHUNK == 0
            and not (head and f != _WG_CHUNK))


def takes_convt_wgmma(c: int, f: int) -> bool:
    """Whether a bf16 K4 call on CUDA tensors runs ``conv_sm90.cu`` (else
    ``conv.cu``'s GEMM): C and F multiples of 64, so that a 64-channel K
    stage and a 256-column tile (one 64-channel chunk of all four
    subpixels) divide them. Every bf16 ConvTranspose of the full-width net
    qualifies."""
    return c % _WG_CHUNK == 0 and f % _WG_CHUNK == 0


def takes_convt_i8_wgmma(c: int, f: int, *, out_i8: bool = True) -> bool:
    """Whether a static-mode K4 call on CUDA tensors runs ``conv_i8_sm90.cu``
    (else ``conv.cu``'s GEMM): C and F multiples of 64 (4F a multiple of the
    256-column tile) and int8 output codes, as every full-width call has."""
    return c % _WG_CHUNK == 0 and f % _WG_CHUNK == 0 and out_i8


def k3_route(cs: Sequence[int], w: Conv3x3Weights, *, head: bool = False,
             pool: bool = False) -> str:
    """The source whose kernel a K3 call on CUDA tensors runs:
    ``"conv_in_sm90"`` (the input conv, ``takes_in_conv``), ``"conv_sm90"``
    (exact bf16, ``takes_wgmma``), ``"conv_i8_sm90"`` (dyn,
    ``takes_dyn_wgmma``; static, ``takes_static_wgmma``) or ``"conv"``
    (``conv.cu``'s GEMM: every other call)."""
    f = int(w.wmat.shape[1])
    if takes_in_conv(cs, f, quant=w.quant, head=head, pool=pool):
        return "conv_in_sm90"
    if takes_wgmma(cs, f, quant=w.quant, out_i8=w.out_i8, head=head):
        return "conv_sm90"
    if w.quant == "dyn" and takes_dyn_wgmma(cs, f, head=head):
        return "conv_i8_sm90"
    if w.quant == "static" and takes_static_wgmma(cs, f, head=head):
        return "conv_i8_sm90"
    return "conv"


def k4_route(c: int, w: ConvT2x2Weights) -> str:
    """The source whose kernel a K4 call on CUDA tensors runs:
    ``"conv_sm90"`` (bf16, ``takes_convt_wgmma``), ``"conv_i8_sm90"``
    (static, ``takes_convt_i8_wgmma``) or ``"conv"``."""
    if w.quant == "static" and takes_convt_i8_wgmma(c, w.f, out_i8=w.out_i8):
        return "conv_i8_sm90"
    if w.quant == "" and takes_convt_wgmma(c, w.f):
        return "conv_sm90"
    return "conv"


def takes_up(c_skip: int, c_deep: int, c_up: int, f: int) -> bool:
    """Whether a fused-ConvTranspose K3 call on CUDA tensors runs
    ``conv_sm90.cu``'s fused kernel (else the card's K4, then K3): skip and
    deep channels multiples of 64, and C_up == F in {64, 128}, so that one
    output tile holds every channel and computes its up values once (JAX's
    fused kernel makes the same one-F-block demand, ``conv_phase.py:837``)."""
    return (c_skip % _WG_CHUNK == 0 and c_deep % _WG_CHUNK == 0 and c_up == f
            and f in (64, 128))


# The JAX package's rule of which decoder levels fuse their ConvTranspose
# (``conv_phase.py:644-712``, the arithmetic ``fuse_up_ok`` reaches): a TPU
# VMEM budget, kept as integer arithmetic because it decides which levels
# JAX's dyn-int8 net runs in exact bf16 (a fused level's conv0).
_WS = 128  # lanes of one phase (conv_phase.py WS)


def _pick_tr_fb_up(h: int, P: int, cs: Sequence[int], F: int, up_cd: int):
    """``_pick_tr_fb(h, P, cs, F, pool=False, head=False, up_cd)``."""
    budget = 11_000_000
    lb = P * _WS
    for tr in (32, 16, 8, 4, 2):
        if h % tr or (up_cd and tr % 2):
            continue
        base = 0
        for i, c in enumerate(cs):
            if up_cd and i == 1:
                base += 2 * (tr // 2 + 2) * up_cd * (lb // 2) * 2
                base += (tr + 2) * c * lb * 2
                base += 2 * 4 * c * up_cd * 2
                base += 4 * c * (lb // 2) * 4
            else:
                base += 2 * (tr + 2) * c * lb * 2
        fbs = [f for f in (F, F // 2, F // 4, F // 8) if f >= 8 and f % 8 == 0]
        k128 = _round_up(3 * sum(cs), 128)
        for fbl in fbs:
            if (up_cd and fbl != F) or (tr > 8 and fbl != F):
                continue
            est = base + 2 * 3 * fbl * k128 * 2 + 3 * fbl * lb * 4 + 2 * fbl * tr * lb * 2
            if est <= budget:
                return tr, fbl
    return 2, 8


def fuse_up_ok(h: int, P: int, c_skip: int, c_up: int, up_cd: int, F: int) -> bool:
    """``conv_phase.fuse_up_ok``: whether JAX fuses a decoder level's
    ConvTranspose (h rows at P phases, skip/up/deep channels, F outputs)."""
    tr, fb = _pick_tr_fb_up(h, P, (c_skip, c_up), F, up_cd)
    return fb == F and tr % 2 == 0 and h % tr == 0


# ---------------------------------------------------------------- plain twins


def _pool2(y: torch.Tensor) -> torch.Tensor:
    n, h, w, f = y.shape
    return y.reshape(n, h // 2, 2, w // 2, 2, f).amax(dim=(2, 4))


def _codes(y: torch.Tensor, relu: bool) -> torch.Tensor:
    """int8 output codes clip(rint(y), 0 or -127, 127)."""
    return torch.clamp(torch.round(y), 0.0 if relu else -127.0, 127.0).to(torch.int8)


def conv3x3_plain(
    xs: Sequence[torch.Tensor], kernel, bias=None, *, relu: bool = False,
    pool: bool = False, head_kernel=None, head_bias=None,
    dtype: torch.dtype = torch.bfloat16,
):
    """Plain torch conv3x3 (``F.conv2d`` in f32). With ``dtype=bfloat16`` it
    follows the kernel's numerics (bf16 weights/bias, one bf16 rounding of
    the output, head on the bf16 output); with float32 nothing is rounded
    (the f32 reference net)."""
    dev = xs[0].device
    k = _as_tensor(kernel, dev)
    b = torch.zeros(k.shape[-1], device=dev) if bias is None else _as_tensor(bias, dev)
    rnd = dtype == torch.bfloat16
    if rnd:
        k, b = _bf16_values(k), _bf16_values(b)
    x = torch.cat([t.to(torch.float32) for t in xs], dim=-1).permute(0, 3, 1, 2)
    y = Fn.conv2d(x, k.permute(3, 2, 0, 1), padding=1) + b[None, :, None, None]
    if relu:
        y = torch.clamp(y, min=0.0)
    y = y.permute(0, 2, 3, 1).to(dtype).contiguous()
    if head_kernel is not None:
        hk = _as_tensor(head_kernel, dev)
        hk = hk[0, 0] if hk.dim() == 4 else hk
        hb = (torch.zeros(hk.shape[1], device=dev) if head_bias is None
              else _as_tensor(head_bias, dev))
        if rnd:
            hk, hb = _bf16_values(hk), _bf16_values(hb)
        return ((torch.matmul(y.to(torch.float32), hk) + hb).to(dtype),)
    if pool:
        return y, _pool2(y)
    return (y,)


def conv3x3_wgmma_plain(xs: Sequence[torch.Tensor], w: Conv3x3Weights, *, relu: bool = False,
                        pool: bool = False, head: Optional[HeadWeights] = None,
                        dtype: torch.dtype = torch.bfloat16):
    """Plain torch twin of ``conv_sm90.cu`` that contracts as the kernel
    walks K: f32 sums, over (tap, input, 64-channel chunk), of the input's
    window shifted by the tap (zeros past the edges) times rows ``tap *
    (C0 + C1) + (C0 if input 1) + c`` of the K-major weights ``w.wmat_t``;
    then bias and ReLU in f32 and, with ``dtype=bfloat16``, one bf16
    rounding. The pool and the head read that output."""
    if w.wmat_t is None:
        raise ValueError("conv3x3_wgmma_plain needs exact bf16 weights with cin, F % 64 == 0")
    cs = [int(x.shape[3]) for x in xs]
    ct = sum(cs)
    _, h, wd, _ = xs[0].shape
    wt = w.wmat_t.to(torch.float32)
    acc = torch.zeros((h * wd, wt.shape[0]), dtype=torch.float32, device=xs[0].device)
    padded = [Fn.pad(x[0].to(torch.float32), (0, 0, 1, 1, 1, 1)) for x in xs]
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        for i, xp in enumerate(padded):
            win = xp[dy:dy + h, dx:dx + wd].reshape(h * wd, cs[i])
            for c in range(0, cs[i], _WG_CHUNK):
                k0 = tap * ct + (cs[0] if i else 0) + c
                acc += win[:, c:c + _WG_CHUNK] @ wt[:, k0:k0 + _WG_CHUNK].t()
    y = acc + w.bias
    if relu:
        y = torch.clamp(y, min=0.0)
    y = y.reshape(1, h, wd, -1).to(dtype)
    if head is not None:
        return ((torch.matmul(y.to(torch.float32), head.hk.to(torch.float32))
                 + head.hb).to(dtype),)
    return (y, _pool2(y)) if pool else (y,)


def conv3x3_in_plain(xs: Sequence[torch.Tensor], w: Conv3x3Weights, *, relu: bool = False):
    """Plain torch twin of ``conv_in_sm90.cu`` that contracts as it walks K:
    A rows are output pixels, columns ``tap * C + c`` (``w.wmat``'s row
    order) of the input's window shifted by the tap (zeros past the edges),
    then at k = 9C a column of ones against the bias as a weight row (its
    values are bf16, so the product is exact), zeros to a multiple of 16;
    f32 sums over k16 steps; then ReLU and one bf16 rounding, or with
    ``w.out_i8`` the codes ``clip(rint(y), 0 or -127, 127)``."""
    cs = [int(x.shape[3]) for x in xs]
    f = int(w.wmat.shape[1])
    if not takes_in_conv(cs, f, quant=w.quant):
        raise ValueError(f"conv3x3_in_plain takes one input of 1-{_IN_MAX_C} channels to "
                         f"{_IN_F} in the exact mode, not {cs} -> {f} ({w.quant!r})")
    _, h, wd, c = xs[0].shape
    k, k16 = 9 * c, _round_up(9 * c + 1, _IN_KSTEP)
    xp = Fn.pad(xs[0][0].to(torch.float32), (0, 0, 1, 1, 1, 1))
    a = torch.cat([xp[dy:dy + h, dx:dx + wd] for dy in range(3) for dx in range(3)]
                  + [torch.ones_like(xp[:h, :wd, :1])], dim=-1)
    a = Fn.pad(a.reshape(h * wd, k + 1), (0, k16 - k - 1))
    wk = Fn.pad(torch.cat([w.wmat[:k].to(torch.float32), w.bias[None]]), (0, 0, 0, k16 - k - 1))
    acc = torch.zeros((h * wd, f), dtype=torch.float32, device=a.device)
    for k0 in range(0, k16, _IN_KSTEP):
        acc += a[:, k0:k0 + _IN_KSTEP] @ wk[k0:k0 + _IN_KSTEP]
    y = torch.clamp(acc, min=0.0) if relu else acc
    y = y.reshape(1, h, wd, f)
    return (_codes(y, relu),) if w.out_i8 else (y.to(torch.bfloat16),)


def dyn_scales_plain(xs: Sequence[torch.Tensor]):
    """The dyn mode's per-output-pixel factors: amax = max |x| over the
    pixel's 3x3 receptive field and all channels of every input; returns
    (127/amax, 0 where amax is 0; amax * f32(1/127)), each (H*W,) f32."""
    a = torch.stack([t[0].to(torch.float32).abs().amax(dim=-1) for t in xs]).amax(dim=0)
    amax = Fn.max_pool2d(a[None, None], 3, stride=1, padding=1)[0, 0].reshape(-1)
    inv = torch.where(amax > 0, torch.div(torch.full_like(amax, 127.0), amax),
                      torch.zeros_like(amax))
    return inv, amax * INV127


def _tap_sums(xs: Sequence[torch.Tensor], wq: torch.Tensor, rinv=None) -> torch.Tensor:
    """(H*W, F) f64 sums of the 3x3 implicit GEMM over int8 codes (``xs``
    int8) or over bf16 inputs quantised per output pixel with ``rinv``.
    Products and partial sums are integers below 2^53, so f64 is exact in
    any order."""
    x = torch.cat([t[0].to(torch.float32) for t in xs], dim=-1)
    h, w, c = x.shape
    xp = Fn.pad(x, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((h * w, wq.shape[1]), dtype=torch.float64, device=x.device)
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        a = xp[dy:dy + h, dx:dx + w].reshape(h * w, c)
        if rinv is not None:
            a = torch.clamp(torch.round(a * rinv[:, None]), -127.0, 127.0)
        acc += a.to(torch.float64) @ wq[tap * c:(tap + 1) * c].to(torch.float64)
    return acc


def conv3x3_prepared_plain(xs: Sequence[torch.Tensor], w: Conv3x3Weights, *,
                           relu: bool = False, pool: bool = False,
                           head: Optional[HeadWeights] = None,
                           up: Optional[ConvT2x2Weights] = None):
    """Plain torch twin of ``conv3x3_prepared`` on the same prepared weights
    (any device): the bf16 mode through ``conv3x3_plain``, the int8 modes
    through exact integer sums and the kernels' f32 epilogue, op for op.
    With ``up`` (``xs = [skip, deep]``) it is the unfused pair's twins,
    ``convt2x2_prepared_plain(deep)`` then the conv over ``[skip, up]``."""
    if up is not None:
        xs = [xs[0], convt2x2_prepared_plain(xs[1], up)]
    _, h, wd, _ = xs[0].shape
    F = int(w.wmat.shape[1])
    K = 9 * w.cin
    if w.quant == "":
        kernel = w.wmat[:K].to(torch.float32).reshape(3, 3, w.cin, -1)
        if not w.out_i8:
            hk = None if head is None else head.hk.to(torch.float32)
            return conv3x3_plain(xs, kernel, w.bias, relu=relu, pool=pool, head_kernel=hk,
                                 head_bias=None if head is None else head.hb)
        (y,) = conv3x3_plain(xs, kernel, w.bias, relu=relu, dtype=torch.float32)
        q = _codes(y, relu)
        return (q, _pool2(q)) if pool else (q,)
    if w.quant == "dyn":
        rinv, rscale = dyn_scales_plain(xs)
        acc = _tap_sums(xs, w.wmat[:K], rinv).to(torch.float32)
        y = acc * (w.scale[None, :] * rscale[:, None]) + w.bias
    else:
        y = _tap_sums(xs, w.wmat[:K]).to(torch.float32) * w.scale + w.bias
    if relu:
        y = torch.clamp(y, min=0.0)
    y = y.reshape(1, h, wd, F)
    out = _codes(y, relu) if w.out_i8 else y.to(torch.bfloat16)
    if head is not None:
        return ((torch.matmul(out.to(torch.float32), head.hk.to(torch.float32))
                 + head.hb).to(torch.bfloat16),)
    return (out, _pool2(out)) if pool else (out,)


def convt2x2_plain(x: torch.Tensor, kernel, bias=None, *,
                   dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain torch flax-ConvTranspose 2x2/s2 (``F.conv_transpose2d`` in
    f32): torch's transposed conv does not flip, so its weight [c, f, dy, dx]
    is flax's ``kernel[1-dy, 1-dx, c, f]``."""
    dev = x.device
    k = _as_tensor(kernel, dev)
    b = torch.zeros(k.shape[-1], device=dev) if bias is None else _as_tensor(bias, dev)
    if dtype == torch.bfloat16:
        k, b = _bf16_values(k), _bf16_values(b)
    wt = torch.flip(k, dims=(0, 1)).permute(2, 3, 0, 1)
    y = Fn.conv_transpose2d(x.to(torch.float32).permute(0, 3, 1, 2), wt, stride=2)
    y = y + b[None, :, None, None]
    return y.permute(0, 2, 3, 1).to(dtype).contiguous()


def convt2x2_prepared_plain(x: torch.Tensor, w: ConvT2x2Weights) -> torch.Tensor:
    """Plain torch twin of ``convt2x2_prepared`` (any device)."""
    _, h, wd, c = x.shape
    if w.quant == "":
        kernel = torch.flip(
            w.wmat[:c].to(torch.float32).reshape(c, 2, 2, w.f).permute(1, 2, 0, 3), dims=(0, 1))
        return convt2x2_plain(x, kernel, w.bias)
    acc = x[0].reshape(h * wd, c).to(torch.float64) @ w.wmat[:c].to(torch.float64)
    y = acc.to(torch.float32).reshape(h * wd, 4, w.f) * w.scale + w.bias
    y = _codes(y, relu=False) if w.out_i8 else y.to(torch.bfloat16)
    return y.reshape(h, wd, 2, 2, w.f).permute(0, 2, 1, 3, 4).reshape(1, 2 * h, 2 * wd, w.f)


def conv3x3_dyn_wgmma_plain(xs: Sequence[torch.Tensor], w: Conv3x3Weights, *,
                            relu: bool = False, pool: bool = False):
    """Plain torch twin of ``conv_i8_sm90.cu``'s dyn kernel that contracts
    as it walks: the per-pixel max |x| then its 3x3 max (``dyn_scales_plain``);
    per 256-channel N tile of the K-major ``w.wmat_t``, the stages (dx, input,
    64-channel chunk), in each the three dy taps and two k32 steps, A being
    the tap's shifted window quantised row by row with its output pixel's
    factor (``clip(rint(x * rinv), -127, 127)``); integer sums (exact in
    f64); then ``f32(acc) * (scale * rscale) + bias``, ReLU, bf16 and the
    pool of the bf16 output."""
    if w.quant != "dyn" or w.wmat_t is None:
        raise ValueError("conv3x3_dyn_wgmma_plain needs dyn weights with cin % 64 == 0 and "
                         "F % 256 == 0")
    cs = [int(x.shape[3]) for x in xs]
    ct = sum(cs)
    _, h, wd, _ = xs[0].shape
    rinv, rscale = dyn_scales_plain(xs)
    wt = w.wmat_t.to(torch.float64)
    F = int(wt.shape[0])
    acc = torch.zeros((h * wd, F), dtype=torch.float64, device=xs[0].device)
    padded = [Fn.pad(x[0].to(torch.float32), (0, 0, 1, 1, 1, 1)) for x in xs]
    for n0 in range(0, F, _I8_BN):
        for dx in range(3):
            for i, xp in enumerate(padded):
                for c in range(0, cs[i], _WG_CHUNK):
                    for dy in range(3):
                        win = xp[dy:dy + h, dx:dx + wd, c:c + _WG_CHUNK].reshape(h * wd, -1)
                        q = torch.clamp(torch.round(win * rinv[:, None]), -127.0, 127.0)
                        k0 = (3 * dy + dx) * ct + (cs[0] if i else 0) + c
                        for s in range(0, _WG_CHUNK, 32):
                            acc[:, n0:n0 + _I8_BN] += (q[:, s:s + 32].to(torch.float64)
                                                      @ wt[n0:n0 + _I8_BN, k0 + s:k0 + s + 32].t())
    y = acc.to(torch.float32) * (w.scale[None, :] * rscale[:, None]) + w.bias
    if relu:
        y = torch.clamp(y, min=0.0)
    y = y.reshape(1, h, wd, F).to(torch.bfloat16)
    return (y, _pool2(y)) if pool else (y,)


def conv3x3_static_wgmma_plain(xs: Sequence[torch.Tensor], w: Conv3x3Weights, *,
                               relu: bool = False, pool: bool = False,
                               head: Optional[HeadWeights] = None):
    """Plain torch twin of ``conv_i8_sm90.cu``'s static kernel that
    contracts as it walks: per 64-channel tile of the K-major ``w.wmat_t``,
    the stages (dx, input, 64-channel chunk), in each the three dy taps and
    two k32 steps over the tap's shifted window of int8 codes; integer sums
    (exact in f64); then
    ``f32(acc) * scale + bias``, ReLU, the codes or bf16, the pool of that
    output and the head on the bf16 output."""
    if w.quant != "static" or w.wmat_t is None:
        raise ValueError("conv3x3_static_wgmma_plain needs static weights with every channel "
                         "count and F % 64 == 0")
    cs = [int(x.shape[3]) for x in xs]
    ct = sum(cs)
    _, h, wd, _ = xs[0].shape
    wt = w.wmat_t.to(torch.float64)
    F = int(wt.shape[0])
    acc = torch.zeros((h * wd, F), dtype=torch.float64, device=xs[0].device)
    padded = [Fn.pad(x[0].to(torch.float64), (0, 0, 1, 1, 1, 1)) for x in xs]
    for n0 in range(0, F, _WG_CHUNK):
        for dx in range(3):
            for i, xp in enumerate(padded):
                for c in range(0, cs[i], _WG_CHUNK):
                    for dy in range(3):
                        win = xp[dy:dy + h, dx:dx + wd, c:c + _WG_CHUNK].reshape(h * wd, -1)
                        k0 = (3 * dy + dx) * ct + (cs[0] if i else 0) + c
                        for s in range(0, _WG_CHUNK, 32):
                            acc[:, n0:n0 + _WG_CHUNK] += (
                                win[:, s:s + 32] @ wt[n0:n0 + _WG_CHUNK, k0 + s:k0 + s + 32].t())
    y = acc.to(torch.float32) * w.scale + w.bias
    if relu:
        y = torch.clamp(y, min=0.0)
    y = y.reshape(1, h, wd, F)
    out = _codes(y, relu) if w.out_i8 else y.to(torch.bfloat16)
    if head is not None:
        return ((torch.matmul(out.to(torch.float32), head.hk.to(torch.float32))
                 + head.hb).to(torch.bfloat16),)
    return (out, _pool2(out)) if pool else (out,)


def convt2x2_wgmma_plain(x: torch.Tensor, w: ConvT2x2Weights) -> torch.Tensor:
    """Plain torch twin of ``conv_sm90.cu``'s bf16 K4 kernel that contracts
    as it walks: tiles of 128 input pixels x 256 GEMM columns of the
    K-major ``w.wmat_t`` (tile u holds rows (u*4 + dy*2 + dx)*64 + j: the
    64-channel chunk u of all four subpixels), K in 64-channel steps and k16
    inside them, f32 sums; then per subpixel ``bias`` in f32, one bf16
    rounding, the 64 channels stored at output pixel (2y+dy, 2x+dx)."""
    if w.quant != "" or w.wmat_t is None:
        raise ValueError("convt2x2_wgmma_plain needs bf16 weights with cin, F % 64 == 0")
    _, h, wd, c = x.shape
    F = w.f
    a = x[0].reshape(h * wd, c).to(torch.float32)
    wt = w.wmat_t.to(torch.float32)
    out = torch.zeros((2 * h, 2 * wd, F), dtype=torch.bfloat16, device=x.device)
    pix = torch.arange(h * wd, device=x.device)
    ys, xs_ = torch.div(pix, wd, rounding_mode="floor"), pix % wd
    for m0 in range(0, h * wd, 128):
        rows = slice(m0, min(m0 + 128, h * wd))
        for u in range(F // _WG_CHUNK):
            cols = slice(4 * _WG_CHUNK * u, 4 * _WG_CHUNK * (u + 1))
            acc = torch.zeros((rows.stop - m0, 4 * _WG_CHUNK), dtype=torch.float32,
                              device=x.device)
            for k in range(0, c, 16):
                acc += a[rows, k:k + 16] @ wt[cols, k:k + 16].t()
            for sub in range(4):
                dy, dx = divmod(sub, 2)
                chans = slice(_WG_CHUNK * u, _WG_CHUNK * (u + 1))
                out[2 * ys[rows] + dy, 2 * xs_[rows] + dx, chans] = (
                    acc[:, _WG_CHUNK * sub:_WG_CHUNK * (sub + 1)] + w.bias[chans]
                ).to(torch.bfloat16)
    return out[None]


def convt2x2_i8_wgmma_plain(x: torch.Tensor, w: ConvT2x2Weights) -> torch.Tensor:
    """Plain torch twin of ``conv_i8_sm90.cu``'s static K4 kernel that
    contracts as it walks: tiles of 128 input pixels x 256 GEMM columns of
    the K-major ``w.wmat_t`` (column n is channel n % F of subpixel
    n // F = (dy, dx)), K in steps of 128 channels and k32 inside them,
    integer sums (exact in f64); then ``f32(acc) * scale + bias`` and the
    codes ``clip(rint(y), -127, 127)``, each 16-column chunk of a tile row
    stored to the 16 contiguous output bytes of its pixel (2y+dy, 2x+dx)."""
    if w.quant != "static" or w.wmat_t is None or not w.out_i8:
        raise ValueError("convt2x2_i8_wgmma_plain needs static int8-output weights with "
                         "cin, F % 64 == 0")
    _, h, wd, c = x.shape
    F = w.f
    a = x[0].reshape(h * wd, c).to(torch.float64)
    wt = w.wmat_t.to(torch.float64)
    out = torch.zeros((2 * h, 2 * wd, F), dtype=torch.int8, device=x.device)
    pix = torch.arange(h * wd, device=x.device)
    ys, xs_ = torch.div(pix, wd, rounding_mode="floor"), pix % wd
    for m0 in range(0, h * wd, 128):
        rows = slice(m0, min(m0 + 128, h * wd))
        for n0 in range(0, 4 * F, _I8_BN):
            acc = torch.zeros((rows.stop - m0, _I8_BN), dtype=torch.float64, device=x.device)
            for k0 in range(0, c, 128):
                for k in range(k0, min(k0 + 128, c), 32):
                    acc += a[rows, k:k + 32] @ wt[n0:n0 + _I8_BN, k:k + 32].t()
            f = torch.arange(n0, n0 + _I8_BN, device=x.device) % F
            y = acc.to(torch.float32) * w.scale[f] + w.bias[f]
            codes = _codes(y, relu=False)
            for ch in range(_I8_BN // 16):
                sub, f0 = divmod(n0 + 16 * ch, F)
                dy, dx = divmod(sub, 2)
                out[2 * ys[rows] + dy, 2 * xs_[rows] + dx, f0:f0 + 16] = \
                    codes[:, 16 * ch:16 * ch + 16]
    return out[None]


# ---------------------------------------------------------------- kernels


def _check_act(x: torch.Tensor, what: str, dtype: torch.dtype) -> None:
    name = "bf16" if dtype == torch.bfloat16 else "int8"
    if x.dtype != dtype or x.dim() != 4 or x.shape[0] != 1:
        raise ValueError(f"{what} must be a (1, H, W, C) {name} tensor")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous NHWC")
    if x.device.type == "cuda" and x.data_ptr() % 16:
        raise ValueError(f"{what} must be 16-byte aligned")


def conv3x3_prepared(
    xs: Sequence[torch.Tensor], w: Conv3x3Weights, *, relu: bool = False,
    pool: bool = False, head: Optional[HeadWeights] = None,
    up: Optional[ConvT2x2Weights] = None,
):
    """conv3x3 on prepared weights (see ``conv3x3``); ``up`` is the fused
    ConvTranspose's (``xs = [skip, deep]``)."""
    if up is not None:
        return _conv3x3_up(xs, w, up, relu=relu, pool=pool, head=head)
    assert len(xs) in (1, 2)
    act = torch.int8 if w.quant == "static" else torch.bfloat16
    for i, x in enumerate(xs):
        _check_act(x, f"xs[{i}]", act)
    _, h, wd, _ = xs[0].shape
    if any(tuple(x.shape[1:3]) != (h, wd) for x in xs):
        raise ValueError("conv3x3 inputs must share H, W")
    cs = [int(x.shape[3]) for x in xs]
    if sum(cs) != w.cin:
        raise ValueError(f"input channels {cs} do not match the kernel's {w.cin}")
    if head is not None and (pool or w.out_i8):
        raise ValueError("the head reads the bf16 conv output; it takes no pool or int8 output")
    if pool and (h % 2 or wd % 2):
        raise ValueError("pool needs even H, W")
    dev = xs[0].device
    if dev.type == "cpu":
        return conv3x3_prepared_plain(xs, w, relu=relu, pool=pool, head=head)
    if dev.type != "cuda" or w.wmat.device != dev:
        raise ValueError("conv3x3: activations and weights must be on one CUDA device")
    route = k3_route(cs, w, head=head is not None, pool=pool)
    if route == "conv_in_sm90":
        return _conv3x3_in(xs, w, relu=relu)
    if route == "conv_sm90":
        return _conv3x3_wgmma(xs, w, relu=relu, pool=pool, head=head)
    if route == "conv_i8_sm90":
        if w.quant == "dyn":
            return _conv3x3_dyn_wgmma(xs, w, relu=relu, pool=pool)
        return _conv3x3_static_wgmma(xs, w, relu=relu, pool=pool, head=head)
    return _conv3x3_gemm(xs, w, relu=relu, pool=pool, head=head)


def _conv3x3_gemm(xs: Sequence[torch.Tensor], w: Conv3x3Weights, *, relu: bool,
                  pool: bool, head: Optional[HeadWeights]):
    """Launch ``conv.cu``'s GEMM (every mode) and its pool / head kernels on
    checked CUDA inputs."""
    dev = xs[0].device
    _, h, wd, _ = xs[0].shape
    cs = [int(x.shape[3]) for x in xs]
    stream = torch.cuda.current_stream(dev).cuda_stream
    F = int(w.wmat.shape[1])
    lib = _lib()
    odt = torch.int8 if w.out_i8 else torch.bfloat16
    out = torch.empty((1, h, wd, F), dtype=odt, device=dev)
    x1 = xs[1].data_ptr() if len(xs) == 2 else None
    c1 = cs[1] if len(xs) == 2 else 0
    rinv = rscale = None
    if w.quant == "dyn":
        rinv = torch.empty(h * wd, dtype=torch.float32, device=dev)
        rscale = torch.empty(h * wd, dtype=torch.float32, device=dev)
        _build.check(lib.rtnr_dyn_scales(xs[0].data_ptr(), x1, cs[0], c1, h, wd,
                                         rinv.data_ptr(), rscale.data_ptr(), stream),
                     "rtnr_dyn_scales")
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = lib.rtnr_conv3x3(xs[0].data_ptr(), x1, cs[0], c1, h, wd, w.wmat.data_ptr(),
                          w.bias.data_ptr(), ptr(w.scale), ptr(rinv), ptr(rscale),
                          out.data_ptr(), F, int(w.wmat.shape[0]), int(relu), _KIND[w.quant],
                          int(w.out_i8), stream)
    _build.check(rc, "rtnr_conv3x3")
    result = (out,)
    if pool:
        pooled = torch.empty((1, h // 2, wd // 2, F), dtype=odt, device=dev)
        _build.check(lib.rtnr_maxpool2(out.data_ptr(), h, wd, F, out.element_size(),
                                       pooled.data_ptr(), stream), "rtnr_maxpool2")
        result = (out, pooled)
    if head is not None:
        oc = int(head.hk.shape[1])
        hout = torch.empty((1, h, wd, oc), dtype=torch.bfloat16, device=dev)
        _build.check(lib.rtnr_head1x1(out.data_ptr(), h * wd, F, head.hk.data_ptr(),
                                      head.hb.data_ptr(), oc, hout.data_ptr(), stream),
                     "rtnr_head1x1")
        result = (hout,)
    if w.quant == "static":
        conv3x3_static.launches += 1
    elif w.quant == "dyn":
        conv3x3_dyn.launches += 1
    elif w.out_i8:
        conv3x3_i8out.launches += 1
    else:
        conv3x3.launches += 1
    return result


def _conv3x3_wgmma(xs: Sequence[torch.Tensor], w: Conv3x3Weights, *, relu: bool,
                   pool: bool, head: Optional[HeadWeights]):
    """Launch ``conv_sm90.cu`` on checked CUDA inputs that ``takes_wgmma``
    accepts."""
    if w.wmat_t is None:
        raise ValueError("conv3x3: these weights lack the K-major copy conv_sm90.cu reads")
    if head is not None and head.hk8 is None:
        raise ValueError("conv3x3: the fused head takes at most 8 output channels")
    dev = xs[0].device
    _, h, wd, _ = xs[0].shape
    cs = [int(x.shape[3]) for x in xs]
    stream = torch.cuda.current_stream(dev).cuda_stream
    F = int(w.wmat.shape[1])
    new = lambda *shape: torch.empty(shape, dtype=torch.bfloat16, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    out = new(1, h, wd, F) if head is None else None
    pooled = new(1, h // 2, wd // 2, F) if pool else None
    oc = 0 if head is None else int(head.hk.shape[1])
    hout = new(1, h, wd, oc) if head is not None else None
    lib = _build.load("conv_sm90", _bind_sm90)
    rc = lib.rtnr_conv3x3_wgmma(
        xs[0].data_ptr(), xs[1].data_ptr() if len(xs) == 2 else None, cs[0],
        cs[1] if len(xs) == 2 else 0, h, wd, w.wmat_t.data_ptr(), w.bias.data_ptr(), ptr(out),
        ptr(pooled), None if head is None else head.hk8.data_ptr(),
        None if head is None else head.hb.data_ptr(), oc, ptr(hout), F, int(relu), stream)
    _build.check(rc, "rtnr_conv3x3_wgmma")
    conv3x3_wgmma.launches += 1
    conv3x3.launches += 1
    if head is not None:
        return (hout,)
    return (out, pooled) if pool else (out,)


def _conv3x3_in(xs: Sequence[torch.Tensor], w: Conv3x3Weights, *, relu: bool):
    """Launch ``conv_in_sm90.cu`` on a checked CUDA input that
    ``takes_in_conv`` accepts; bf16 output, or int8 codes for
    ``w.out_i8``."""
    x = xs[0]
    _, h, wd, c = x.shape
    dev = x.device
    F = int(w.wmat.shape[1])
    out = torch.empty((1, h, wd, F), dtype=torch.int8 if w.out_i8 else torch.bfloat16,
                      device=dev)
    rc = _build.load("conv_in_sm90", _bind_in).rtnr_conv3x3_in(
        x.data_ptr(), c, h, wd, w.wmat.data_ptr(), int(w.wmat.shape[0]), w.bias.data_ptr(),
        out.data_ptr(), int(w.out_i8), int(relu), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "rtnr_conv3x3_in")
    conv3x3_in.launches += 1
    if w.out_i8:
        conv3x3_i8out.launches += 1
    else:
        conv3x3.launches += 1
    return (out,)


def _i8_lib() -> ctypes.CDLL:
    return _build.load("conv_i8_sm90", _bind_i8)


def _conv3x3_dyn_wgmma(xs: Sequence[torch.Tensor], w: Conv3x3Weights, *, relu: bool,
                       pool: bool):
    """Launch ``conv_i8_sm90.cu``'s dyn kernel (its per-pixel max pre-pass,
    then the conv) on checked CUDA inputs that ``takes_dyn_wgmma`` accepts."""
    if w.wmat_t is None:
        raise ValueError("conv3x3: these dyn weights lack the K-major copy conv_i8_sm90.cu reads")
    dev = xs[0].device
    _, h, wd, _ = xs[0].shape
    cs = [int(x.shape[3]) for x in xs]
    F = int(w.wmat.shape[1])
    out = torch.empty((1, h, wd, F), dtype=torch.bfloat16, device=dev)
    pooled = (torch.empty((1, h // 2, wd // 2, F), dtype=torch.bfloat16, device=dev)
              if pool else None)
    amax = torch.empty(h * wd, dtype=torch.float32, device=dev)
    rc = _i8_lib().rtnr_conv3x3_dyn_wgmma(
        xs[0].data_ptr(), xs[1].data_ptr() if len(xs) == 2 else None, cs[0],
        cs[1] if len(xs) == 2 else 0, h, wd, w.wmat_t.data_ptr(), w.scale.data_ptr(),
        w.bias.data_ptr(), amax.data_ptr(), out.data_ptr(),
        None if pooled is None else pooled.data_ptr(), F, int(relu),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "rtnr_conv3x3_dyn_wgmma")
    conv3x3_dyn_wgmma.launches += 1
    conv3x3_dyn.launches += 1
    return (out, pooled) if pool else (out,)


def _conv3x3_static_wgmma(xs: Sequence[torch.Tensor], w: Conv3x3Weights, *, relu: bool,
                          pool: bool, head: Optional[HeadWeights]):
    """Launch ``conv_i8_sm90.cu``'s static kernel on checked CUDA inputs that
    ``takes_static_wgmma`` accepts."""
    if w.wmat_t is None:
        raise ValueError("conv3x3: these static weights lack the K-major copy conv_i8_sm90.cu "
                         "reads")
    if head is not None and head.hk8 is None:
        raise ValueError("conv3x3: the fused head takes at most 8 output channels")
    dev = xs[0].device
    _, h, wd, _ = xs[0].shape
    cs = [int(x.shape[3]) for x in xs]
    F = int(w.wmat.shape[1])
    odt = torch.int8 if w.out_i8 else torch.bfloat16
    ptr = lambda t: None if t is None else t.data_ptr()
    out = torch.empty((1, h, wd, F), dtype=odt, device=dev) if head is None else None
    pooled = torch.empty((1, h // 2, wd // 2, F), dtype=odt, device=dev) if pool else None
    oc = 0 if head is None else int(head.hk.shape[1])
    hout = (torch.empty((1, h, wd, oc), dtype=torch.bfloat16, device=dev)
            if head is not None else None)
    rc = _i8_lib().rtnr_conv3x3_static_wgmma(
        xs[0].data_ptr(), xs[1].data_ptr() if len(xs) == 2 else None, cs[0],
        cs[1] if len(xs) == 2 else 0, h, wd, w.wmat_t.data_ptr(), w.scale.data_ptr(),
        w.bias.data_ptr(), ptr(out), ptr(pooled), int(w.out_i8),
        None if head is None else head.hk8.data_ptr(),
        None if head is None else head.hb.data_ptr(), oc, ptr(hout), F, int(relu),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "rtnr_conv3x3_static_wgmma")
    conv3x3_static_wgmma.launches += 1
    conv3x3_static.launches += 1
    if head is not None:
        return (hout,)
    return (out, pooled) if pool else (out,)


def _conv3x3_up(xs: Sequence[torch.Tensor], w: Conv3x3Weights, up: ConvT2x2Weights, *,
                relu: bool, pool: bool, head: Optional[HeadWeights]):
    """K3's fused-ConvTranspose mode: the conv over ``[skip,
    convt2x2(deep)]`` (module doc)."""
    if len(xs) != 2:
        raise ValueError("the fused ConvTranspose takes xs = [skip, deep]")
    if pool or head is not None or w.quant or w.out_i8 or up.quant:
        raise ValueError("the fused ConvTranspose is bf16 only, with no pool or head")
    skip, deep = xs
    _check_act(skip, "skip", torch.bfloat16)
    _check_act(deep, "deep", torch.bfloat16)
    _, h, wd, cs = skip.shape
    if tuple(deep.shape[1:]) != (h // 2, wd // 2, up.cin) or h % 2 or wd % 2:
        raise ValueError(f"deep {tuple(deep.shape)} is not the (1, H/2, W/2, {up.cin}) of skip "
                         f"{tuple(skip.shape)}")
    if cs + up.f != w.cin:
        raise ValueError(f"skip {cs} + up {up.f} channels do not match the kernel's {w.cin}")
    dev = skip.device
    if dev.type == "cpu":
        return conv3x3_prepared_plain(xs, w, relu=relu, up=up)
    if dev.type != "cuda" or w.wmat.device != dev or up.wmat.device != dev:
        raise ValueError("conv3x3: activations and weights must be on one CUDA device")
    F = int(w.wmat.shape[1])
    if not takes_up(int(cs), up.cin, up.f, F):
        # the unfused pair of card kernels, each counted as itself
        return conv3x3_prepared([skip, convt2x2_prepared(deep, up)], w, relu=relu)
    if w.wmat_t is None or up.wmat_t is None:
        raise ValueError("conv3x3: these weights lack the K-major copies conv_sm90.cu reads")
    out = torch.empty((1, h, wd, F), dtype=torch.bfloat16, device=dev)
    lib = _build.load("conv_sm90", _bind_sm90)
    rc = lib.rtnr_conv3x3_up_wgmma(
        skip.data_ptr(), deep.data_ptr(), int(cs), up.cin, h, wd, up.wmat_t.data_ptr(),
        up.bias.data_ptr(), w.wmat_t.data_ptr(), w.bias.data_ptr(), out.data_ptr(), F,
        int(relu), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "rtnr_conv3x3_up_wgmma")
    conv3x3_up.launches += 1
    return (out,)


def conv3x3(xs: Sequence[torch.Tensor], kernel, bias=None, *, relu: bool = False,
            pool: bool = False, head_kernel=None, head_bias=None, quant: str = "",
            in_scales=None, out_scale=None, up_kernel=None, up_bias=None):
    """K3: 3x3 same conv over the virtual concat of ``xs`` (one or two
    (1,H,W,C) tensors: bf16, or int8 codes in static mode), flax kernel
    (3,3,sumC,F). With ``up_kernel`` (2,2,C_deep,C_up) ``xs = [skip, deep]``
    and the ConvTranspose of ``deep`` is fused in. See module doc."""
    dev = xs[0].device
    w = prepare_conv3x3(kernel, bias, dev, quant=quant, in_scales=in_scales,
                        out_scale=out_scale, c0=int(xs[0].shape[3]))
    head = None if head_kernel is None else prepare_head(head_kernel, head_bias, dev)
    up = None if up_kernel is None else prepare_convt2x2(up_kernel, up_bias, dev)
    return conv3x3_prepared(xs, w, relu=relu, pool=pool, head=head, up=up)


conv3x3.launches = 0


def convt2x2_prepared(x: torch.Tensor, w: ConvT2x2Weights) -> torch.Tensor:
    """convt2x2 on prepared weights (see ``convt2x2``)."""
    _check_act(x, "x", torch.int8 if w.quant == "static" else torch.bfloat16)
    _, h, wd, c = x.shape
    if c != w.cin:
        raise ValueError(f"input channels {c} do not match the kernel's {w.cin}")
    dev = x.device
    if dev.type == "cpu":
        return convt2x2_prepared_plain(x, w)
    if dev.type != "cuda" or w.wmat.device != dev:
        raise ValueError("convt2x2: activations and weights must be on one CUDA device")
    route = k4_route(c, w)
    if route == "conv_i8_sm90":
        return _convt2x2_i8_wgmma(x, w)
    if route == "conv_sm90":
        return _convt2x2_wgmma(x, w)
    return _convt2x2_gemm(x, w)


def _convt2x2_gemm(x: torch.Tensor, w: ConvT2x2Weights) -> torch.Tensor:
    """Launch ``conv.cu``'s GEMM (bf16 and static) on a checked CUDA input."""
    _, h, wd, c = x.shape
    dev = x.device
    odt = torch.int8 if w.out_i8 else torch.bfloat16
    out = torch.empty((1, 2 * h, 2 * wd, w.f), dtype=odt, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib().rtnr_convt2x2(x.data_ptr(), c, h, wd, w.wmat.data_ptr(), w.bias.data_ptr(),
                              None if w.scale is None else w.scale.data_ptr(), out.data_ptr(),
                              w.f, int(w.wmat.shape[0]), _KIND[w.quant], int(w.out_i8), stream)
    _build.check(rc, "rtnr_convt2x2")
    if w.quant == "static":
        convt2x2_static.launches += 1
    else:
        convt2x2.launches += 1
    return out


def _convt2x2_wgmma(x: torch.Tensor, w: ConvT2x2Weights) -> torch.Tensor:
    """Launch ``conv_sm90.cu``'s bf16 K4 kernel on a checked CUDA input that
    ``takes_convt_wgmma`` accepts."""
    if w.wmat_t is None:
        raise ValueError("convt2x2: these bf16 weights lack the K-major copy conv_sm90.cu reads")
    _, h, wd, c = x.shape
    dev = x.device
    out = torch.empty((1, 2 * h, 2 * wd, w.f), dtype=torch.bfloat16, device=dev)
    rc = _build.load("conv_sm90", _bind_sm90).rtnr_convt2x2_wgmma(
        x.data_ptr(), c, h, wd, w.wmat_t.data_ptr(), w.bias.data_ptr(), out.data_ptr(), w.f,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "rtnr_convt2x2_wgmma")
    convt2x2_wgmma.launches += 1
    convt2x2.launches += 1
    return out


def _convt2x2_i8_wgmma(x: torch.Tensor, w: ConvT2x2Weights) -> torch.Tensor:
    """Launch ``conv_i8_sm90.cu``'s static K4 kernel on a checked CUDA input
    that ``takes_convt_i8_wgmma`` accepts."""
    if w.wmat_t is None:
        raise ValueError("convt2x2: these static weights lack the K-major copy conv_i8_sm90.cu "
                         "reads")
    _, h, wd, c = x.shape
    dev = x.device
    out = torch.empty((1, 2 * h, 2 * wd, w.f), dtype=torch.int8, device=dev)
    rc = _i8_lib().rtnr_convt2x2_i8_wgmma(x.data_ptr(), c, h, wd, w.wmat_t.data_ptr(),
                                          w.scale.data_ptr(), w.bias.data_ptr(), out.data_ptr(),
                                          w.f, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "rtnr_convt2x2_i8_wgmma")
    convt2x2_static_wgmma.launches += 1
    convt2x2_static.launches += 1
    return out


def convt2x2(x: torch.Tensor, kernel, bias=None, *, quant: str = "", in_scale=None,
             out_scale=None) -> torch.Tensor:
    """K4: flax 2x2 stride-2 ConvTranspose of (1,H,W,C) bf16 (or int8 codes
    in static mode) with kernel (2,2,C,F) plus bias -> (1,2H,2W,F)."""
    return convt2x2_prepared(x, prepare_convt2x2(kernel, bias, x.device, quant=quant,
                                                 in_scale=in_scale, out_scale=out_scale))


convt2x2.launches = 0
