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

``forward`` is the kernel path: exact bf16, or with ``quant_int8`` the int8
topologies of ``_phase_forward`` (``unet.py:590-711``): static int8 when
``act_scales`` (from ``calibrate_act_scales``) are given, else dynamic int8
on the levels with ``f >= quant_min_f``. ``forward_plain`` is the plain
torch twin net (``dtype=float32`` is the f32 reference, ``bfloat16``
repeats the kernels' rounding; with ``quant_int8`` the same int8 topology on
the int8 twins).

What JAX runs only on its phase path runs here only where that path would
run (``int8_applies``: the shape terms of ``phase_input_ok``, and the
caller's pyramid levels equal to ``len(features)``): int8, and, with
``RTNR_FUSE_UP=1`` read at each forward, the ConvTranspose fused into
``updc{i}/conv0`` on the levels where JAX's ``fuse_up_ok`` holds
(``unet.py:578-588, 670-678``; never static, never in calibration).
Elsewhere a ``quant_int8`` net runs exact bf16, as JAX's XLA path does. The
backend term of ``phase_input_ok`` (a TPU and >= 2^20 pixels) is not
mirrored.

``UNetTrain`` is the un-folded net for training (``UNet.__call__`` with
BatchNorm, ``rtnr_tpu/models/unet.py:478-522``): plain ``F.conv2d`` /
``F.conv_transpose2d``, as the JAX package trains on XLA's own convs, and
each BatchNorm + ReLU on the card on the fused kernels of ``ops.bn_train``.
"""

from __future__ import annotations

import functools
import os
from typing import AbstractSet, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as Fn
from torch import nn

from rtnr_tpu_torch.models.convert import unet_layer_names
from rtnr_tpu_torch.ops.bn_train import EPS as BN_EPS
from rtnr_tpu_torch.ops.bn_train import bn_relu_train
from rtnr_tpu_torch.ops.conv import (
    INV127,
    conv3x3_plain,
    conv3x3_prepared,
    conv3x3_prepared_plain,
    convt2x2_plain,
    convt2x2_prepared,
    convt2x2_prepared_plain,
    fuse_up_ok,
    prepare_conv3x3,
    prepare_convt2x2,
    prepare_head,
)


def int8_shape_ok(features: Sequence[int], h: int, w: int) -> bool:
    """The shape terms of JAX's ``phase_input_ok`` (``unet.py:210-228``) for
    an (h, w) input, n = len(features): ``h % (4 << n) == 0``, ``w % 2^n ==
    0``, ``w / 2^n <= 128`` and ``features[0] % 8 == 0``. Where they fail,
    JAX's net runs its XLA path: exact bf16, unfused."""
    n = len(features)
    return (h % (4 << n) == 0 and w % (1 << n) == 0 and w >> n <= 128
            and features[0] % 8 == 0)


def _buf(name: str) -> str:
    return name.replace("/", "__")


class UNet(nn.Module):
    """Inference U-Net over a flat folded state (``models.convert``).

    ``quant_int8`` / ``quant_min_f`` are the JAX ``UNet``'s attributes
    (``unet.py:419-425``): with ``quant_int8`` the kernel path runs int8,
    static when ``forward`` gets ``act_scales``, else dynamic on the levels
    with ``f >= quant_min_f``."""

    def __init__(self, state: Dict[str, np.ndarray], features: Sequence[int] = (64, 128, 256, 512),
                 out_channels: int = 3, quant_int8: bool = False, quant_min_f: int = 256):
        super().__init__()
        self.features = tuple(features)
        self.out_channels = out_channels
        self.quant_int8 = quant_int8
        self.quant_min_f = quant_min_f
        self.conv_names, self.up_names = unet_layer_names(len(self.features))
        for name in self.conv_names + self.up_names + ["final_conv"]:
            for part in ("kernel", "bias"):
                key = f"{name}/{part}"
                self.register_buffer(_buf(key), torch.tensor(np.asarray(state[key], np.float32)))
        self._prepared: Optional[dict] = None
        self._prepared_int8: Optional[dict] = None

    def param(self, key: str) -> torch.Tensor:
        return getattr(self, _buf(key))

    def _device(self) -> torch.device:
        return self.param("final_conv/bias").device

    def _prepare_plan(self, plan: Dict[str, dict]) -> dict:
        """Prepared weights of every layer; ``plan`` maps a layer to its
        mode's keyword arguments (absent: exact bf16)."""
        n = len(self.features)
        p = {"device": self._device()}
        for name in self.conv_names:
            c0 = None
            if name.startswith("updc") and name.endswith("conv0"):  # [skip, up]
                c0 = self.features[n - 1 - int(name[4:name.index("/")])]
            p[name] = prepare_conv3x3(self.param(f"{name}/kernel"), self.param(f"{name}/bias"),
                                      c0=c0, **plan.get(name, {}))
        for name in self.up_names:
            p[name] = prepare_convt2x2(self.param(f"{name}/kernel"), self.param(f"{name}/bias"),
                                       **plan.get(name, {}))
        p["final_conv"] = prepare_head(self.param("final_conv/kernel"),
                                       self.param("final_conv/bias"))
        return p

    def prepare(self) -> dict:
        """Lay the weights out for the exact bf16 kernels once, on the
        buffers' device; re-done only if the module moved."""
        if self._prepared is None or self._prepared["device"] != self._device():
            self._prepared = self._prepare_plan({})
        return self._prepared

    def int8_plan(self, act_scales: Optional[dict] = None,
                  fused: AbstractSet[int] = frozenset()) -> Dict[str, dict]:
        """Each layer's int8 mode (``_phase_forward``, ``unet.py:607-706``).

        Static (``act_scales``): ``down0/conv0`` exact bf16 with int8 output
        at ``down0/c0``; every other conv and ConvTranspose static from its
        input's scale to its output's; ``updc{i}/conv0`` reads [skip, up] at
        (``down{n-1-i}/c1``, ``u{i}t``); the last conv writes bf16 for the
        head. Dyn: a level quantises when ``f >= quant_min_f``, except the
        encoder's level-0 conv0 and the conv0 of a ``fused`` decoder level
        (the fused ConvTranspose is bf16 only, ``unet.py:678``); the
        bottleneck uses ``2*features[-1]``; the ConvTranspose stays bf16."""
        n = len(self.features)
        plan: Dict[str, dict] = {}
        if act_scales is not None:
            def st(ins, out):
                return dict(quant="static", in_scales=tuple(act_scales[k] for k in ins),
                            out_scale=None if out is None else act_scales[out])

            for i in range(n):
                plan[f"down{i}/conv0"] = (dict(out_scale=act_scales["down0/c0"]) if i == 0
                                          else st((f"down{i - 1}/c1",), f"down{i}/c0"))
                plan[f"down{i}/conv1"] = st((f"down{i}/c0",), f"down{i}/c1")
            plan["bottleneck/conv0"] = st((f"down{n - 1}/c1",), "bottleneck/c0")
            plan["bottleneck/conv1"] = st(("bottleneck/c0",), "bottleneck/c1")
            for i in range(n):
                prev = "bottleneck/c1" if i == 0 else f"updc{i - 1}/c1"
                plan[f"up{i}"] = dict(quant="static", in_scale=act_scales[prev],
                                      out_scale=act_scales[f"u{i}t"])
                plan[f"updc{i}/conv0"] = st((f"down{n - 1 - i}/c1", f"u{i}t"), f"updc{i}/c0")
                plan[f"updc{i}/conv1"] = st((f"updc{i}/c0",),
                                            None if i == n - 1 else f"updc{i}/c1")
            return plan

        def dyn(on):
            return dict(quant="dyn") if on else {}

        for i, f in enumerate(self.features):
            q = f >= self.quant_min_f
            plan[f"down{i}/conv0"] = dyn(q and i > 0)
            plan[f"down{i}/conv1"] = dyn(q)
        qb = 2 * self.features[-1] >= self.quant_min_f
        plan["bottleneck/conv0"] = plan["bottleneck/conv1"] = dyn(qb)
        for i, f in enumerate(reversed(self.features)):
            q = f >= self.quant_min_f
            plan[f"updc{i}/conv0"] = dyn(q and i not in fused)
            plan[f"updc{i}/conv1"] = dyn(q)
        return plan

    def prepare_int8(self, act_scales: Optional[dict] = None,
                     fused: AbstractSet[int] = frozenset()) -> dict:
        """Prepared weights of the int8 topology (static with ``act_scales``,
        else dyn with the ``fused`` levels), made once per scales object,
        fused levels, ``quant_min_f`` and device."""
        c = self._prepared_int8
        key = (self.quant_min_f, self._device(), frozenset(fused))
        if c is None or c["scales"] is not act_scales or c["key"] != key:
            c = {"scales": act_scales, "key": key,
                 "p": self._prepare_plan(self.int8_plan(act_scales, fused))}
            self._prepared_int8 = c
        return c["p"]

    def int8_applies(self, h: int, w: int) -> bool:
        """``int8_shape_ok`` for this net's widths."""
        return int8_shape_ok(self.features, h, w)

    def fuse_levels(self, h: int) -> frozenset:
        """The decoder levels whose ConvTranspose JAX fuses for an h-row
        input (``fuse_up_ok(hs, 2P, f, f, cc, f)`` per level, ``unet.py:
        670-671``): level i has ``h >> (n-1-i)`` rows at ``2 << i`` phases
        and reads ``cc`` deep channels."""
        n = len(self.features)
        out, cc = set(), 2 * self.features[-1]
        for i, f in enumerate(reversed(self.features)):
            if fuse_up_ok(h >> (n - 1 - i), 2 << i, f, f, cc, f):
                out.add(i)
            cc = f
        return frozenset(out)

    def _plan(self, x: torch.Tensor, act_scales: Optional[dict], levels: Optional[int]):
        """(prepared weights, fused levels) of a forward on ``x``; ``levels``
        is the caller's pyramid levels (None: the net's own)."""
        _, h, w, _ = x.shape
        phase = levels in (None, len(self.features)) and self.int8_applies(h, w)
        static = self.quant_int8 and act_scales is not None
        fused = frozenset()
        if phase and not static and os.environ.get("RTNR_FUSE_UP") == "1":
            fused = self.fuse_levels(h)
        if self.quant_int8 and phase:
            return self.prepare_int8(act_scales, fused), fused
        return self.prepare(), fused

    def _run(self, x, conv, convt, convup=None, fused: AbstractSet[int] = frozenset()):
        """The net's topology over the layer callables; a level in ``fused``
        runs ``convup(skip, deep, i)`` in place of ``up{i}`` and
        ``updc{i}/conv0``."""
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
            skip = skips[-(i + 1)]
            if i in fused:
                (y,) = convup(skip, h, i)
            else:
                up = convt(h, f"up{i}")
                assert up.shape[:3] == skip.shape[:3], (
                    f"decoder level {i}: up {tuple(up.shape)} vs skip {tuple(skip.shape)}; "
                    f"pad the input to a multiple of {1 << n}")
                (y,) = conv([skip, up], f"updc{i}/conv0")
            (h,) = conv([y], f"updc{i}/conv1", head=i == n - 1)
        return h

    def _check_input(self, x: torch.Tensor) -> None:
        m = 1 << len(self.features)
        if x.dim() != 4 or x.shape[0] < 1 or x.shape[1] % m or x.shape[2] % m:
            raise ValueError(f"U-Net input must be (B, H, W, C) with H, W multiples of {m}; "
                             f"got {tuple(x.shape)}")

    @staticmethod
    def _frames(x: torch.Tensor, run) -> torch.Tensor:
        """``run`` on each frame of the batch, one after another over the
        same prepared weights, concatenated (JAX's phase path unrolls a batch
        the same way, ``rtnr_tpu/models/unet.py:537-550, 710-711``)."""
        if x.shape[0] == 1:
            return run(x)
        return torch.cat([run(x[i:i + 1]) for i in range(x.shape[0])])

    def _run_prepared(self, x: torch.Tensor, p: dict, conv3x3_fn, convt2x2_fn,
                      fused: AbstractSet[int] = frozenset()) -> torch.Tensor:
        def conv(xs, name, pool=False, head=False):
            return conv3x3_fn(xs, p[name], relu=True, pool=pool,
                              head=p["final_conv"] if head else None)

        def convt(h, name):
            return convt2x2_fn(h, p[name])

        def convup(skip, deep, i):
            return conv3x3_fn([skip, deep], p[f"updc{i}/conv0"], relu=True, up=p[f"up{i}"])

        return self._run(x.to(torch.bfloat16).contiguous(), conv, convt, convup, fused)

    def forward(self, x: torch.Tensor, act_scales: Optional[dict] = None, *,
                levels: Optional[int] = None) -> torch.Tensor:
        """Forward on the K3/K4 kernels: (B,H,W,5) -> (B,H,W,out) bf16, frame
        by frame (``_frames``). Exact bf16, or with ``quant_int8`` static int8
        (``act_scales``) or dyn int8 where ``int8_applies`` and ``levels``
        (the caller's pyramid levels, None: the net's own) equals
        ``len(features)``, else exact bf16; ``act_scales`` is ignored without ``quant_int8``, as in JAX.
        ``RTNR_FUSE_UP=1`` fuses the ConvTranspose where JAX would (module
        doc)."""
        self._check_input(x)
        p, fused = self._plan(x, act_scales, levels)
        return self._frames(x, lambda f: self._run_prepared(f, p, conv3x3_prepared,
                                                            convt2x2_prepared, fused))

    def forward_plain(self, x: torch.Tensor, dtype: torch.dtype = torch.float32,
                      act_scales: Optional[dict] = None) -> torch.Tensor:
        """Plain torch twin net in ``dtype`` (float32: the f32 reference).
        With ``quant_int8`` it is ``forward``'s topology (int8 where it
        applies, else exact bf16) on the twins (bf16 out; ``dtype`` is not
        read). A batch runs frame by frame, as ``forward``."""
        self._check_input(x)
        if self.quant_int8:
            p, fused = self._plan(x, act_scales, None)
            return self._frames(x, lambda f: self._run_prepared(
                f, p, conv3x3_prepared_plain, convt2x2_prepared_plain, fused))

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

        return self._frames(x, lambda f: self._run(f.to(dtype).contiguous(), conv, convt))


def calibrate_act_scales(unet: UNet, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Static-int8 calibration (``unet.py:714-744``): one exact bf16 forward
    of ``unet`` on a representative (B,H,W,5) input, recording ``max|y|``
    of every conv0 output, every conv1 output before the pool except the
    head conv's, and every ConvTranspose output, under the JAX package's
    keys (``down{i}/c0``, ``bottleneck/c1``, ``u{i}t``, ``updc{i}/c0``, ...;
    the ``sow`` points of ``unet.py:318-332, 690-692``). Each scale is
    ``max(m, 1e-8) * f32(1/127)``, a 0-d f32 tensor on the net's device:
    nothing goes back to the host. Over a batch the frames run one by one and
    each key keeps its max over all frames, as JAX folds a layer's repeated
    ``sow`` values with ``jnp.maximum``."""
    unet._check_input(x)
    p = unet.prepare()
    seen: Dict[str, torch.Tensor] = {}

    def record(key: str, t: torch.Tensor) -> None:
        m = t.to(torch.float32).abs().amax()
        seen[key] = m if key not in seen else torch.maximum(seen[key], m)

    def conv(xs, name, pool=False, head=False):
        out = conv3x3_prepared(xs, p[name], relu=True, pool=pool,
                               head=p["final_conv"] if head else None)
        block, layer = name.split("/")
        if layer == "conv0":
            record(f"{block}/c0", out[0])
        elif not head:
            record(f"{block}/c1", out[0])
        return out

    def convt(h, name):
        y = convt2x2_prepared(h, p[name])
        record(f"u{name[2:]}t", y)
        return y

    with torch.no_grad():
        for i in range(x.shape[0]):
            unet._run(x[i:i + 1].to(torch.bfloat16).contiguous(), conv, convt)
    return {k: torch.clamp_min(m, 1e-8) * INV127 for k, m in seen.items()}


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
    unbiased one). In training mode each BatchNorm and the ReLU after it are
    one ``ops.bn_train.bn_relu_train``: the fused kernels of
    ``csrc/bn_train.cu`` on a CUDA tensor, the plain torch layer on the CPU.

    ``dtype`` follows flax's ``dtype``: parameters stay f32; with bfloat16
    every conv runs in bf16 (inputs and kernels rounded), BatchNorm
    normalises in f32 and rounds its output to bf16. Skip and up-sampled
    tensors are concatenated ``[skip, up]`` (one conv over the concat, the
    same math as the JAX package's split conv); inputs must be padded to a
    multiple of 2**levels, so no bilinear resize arises.

    ``sync_batch_stats(mesh, axis)`` (multi-rank training): the batch
    statistics are those of the global batch sharded over the mesh's
    ``axis``, as JAX's BatchNorm sees it under ``jit``: each rank's sums of x
    and x^2 and its element count are summed over the axis before the
    division, by a sum whose backward sums the gradients too
    (``parallel.collectives.psum_autograd``), so every rank's gradients
    include the other ranks' frames. Without it, or over one rank, the
    statistics are the batch's ``mean``s.
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
        self._bn_sync = None

    def param(self, key: str) -> torch.Tensor:
        return getattr(self, _buf(key))

    def sync_batch_stats(self, mesh, axis: Optional[str]) -> None:
        """Batch statistics over ``axis`` of ``mesh`` (class doc); None
        clears it."""
        self._bn_sync = None if axis is None or mesh.size(axis) == 1 else (mesh, axis)

    def _bn_reduce(self):
        """The sum over ranks of a per-channel vector, with the sum of the
        gradients as its gradient (None: this rank alone)."""
        if self._bn_sync is None:
            return None
        from rtnr_tpu_torch.parallel.collectives import psum_autograd

        mesh, axis = self._bn_sync
        return functools.partial(psum_autograd, mesh=mesh, axis=axis)

    def _bn_relu(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """BatchNorm ``name`` then ReLU of the conv output ``x``: in training
        mode ``ops.bn_train.bn_relu_train`` (the fused kernels on the card,
        the plain layer on the CPU), else the running statistics."""
        scale, bias = self.param(f"{name}/scale"), self.param(f"{name}/bias")
        mean, var = self.param(f"{name}/mean"), self.param(f"{name}/var")
        if self.training:
            return bn_relu_train(x, scale, bias, mean, var, self._bn_reduce())
        mul = torch.rsqrt(var + BN_EPS) * scale
        y = (x.to(torch.float32) - mean[:, None, None]) * mul[:, None, None] + bias[:, None, None]
        return torch.relu(y.to(self.dtype))

    def _double_conv(self, block: str, xs: List[torch.Tensor]) -> torch.Tensor:
        x = xs[0] if len(xs) == 1 else torch.cat(xs, dim=1)
        for j in range(2):
            k = self.param(f"{block}/conv{j}/kernel").permute(3, 2, 0, 1).to(self.dtype)
            x = self._bn_relu(Fn.conv2d(x, k, padding=1), f"{block}/bn{j}")
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
