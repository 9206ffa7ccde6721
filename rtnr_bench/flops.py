"""Operations and bytes of the U-Net's convs, and the H100's published peaks.

A frozen copy of the arithmetic of the repository's ``chip_smoke.py``
(``bound_ms`` and the per-call counts of its K3 / K4 rows): operations are
two per multiply-add, counted from the shapes; bytes are each input read
once and each output written once at the precision that the mode stores
(bf16 2 bytes, int8 1), the weights once, the per-channel scale and bias
as 8 bytes a channel. A conv's least time is the larger of its operations
over the peak of its precision and its bytes over the memory bandwidth.

Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W power limit.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

PEAKS = {"bf16": 989e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12
POWER_LIMIT_W = 700.0


def unet_calls(features: Sequence[int], h: int, w: int, mode: str, in_channels: int = 5,
               out_channels: int = 3) -> List[Dict]:
    """One entry per conv call of a forward at the padded (h, w):
    {name, ops: {precision: ops}, bytes}. ``mode``: "bf16" or "static"
    (static int8: the input conv reads bf16 and writes int8 codes, every
    other conv and ConvTranspose is int8, the last conv writes bf16 and the
    1x1 head runs in bf16 on its output)."""
    n = len(features)
    static = mode == "static"
    calls = []

    def conv(name, hh, ww, cs, f, *, pool=False, head=0, first=False, last=False):
        m = hh * ww
        ct = sum(cs)
        quant = static and not first
        prec = "int8" if quant else "bf16"
        ops = {prec: 2.0 * m * f * 9 * ct}
        if head:
            ops["bf16"] = ops.get("bf16", 0.0) + 2.0 * m * f * head
        in_b = 1.0 if quant else 2.0
        out_b = 1.0 if static and not last else 2.0
        out_bytes = (2.0 * m * head if head else out_b * m * f) + (out_b * m * f / 4 if pool
                                                                   else 0.0)
        nbytes = in_b * m * ct + (1.0 if quant else 2.0) * 9 * ct * f + 8.0 * f + out_bytes
        calls.append({"name": name, "ops": ops, "bytes": nbytes})

    def convt(name, hh, ww, c, f):
        m = hh * ww
        b = 1.0 if static else 2.0
        calls.append({"name": name, "ops": {"int8" if static else "bf16": 2.0 * m * 4 * f * c},
                      "bytes": b * m * c + b * 4 * c * f + 8.0 * f + b * 4 * m * f})

    hh, ww, cin = h, w, in_channels
    for i, f in enumerate(features):
        conv(f"down{i}/conv0", hh, ww, [cin], f, first=i == 0)
        conv(f"down{i}/conv1", hh, ww, [f], f, pool=True)
        hh, ww, cin = hh // 2, ww // 2, f
    fb = 2 * features[-1]
    conv("bottleneck/conv0", hh, ww, [cin], fb)
    conv("bottleneck/conv1", hh, ww, [fb], fb)
    cin = fb
    for i, f in enumerate(reversed(features)):
        convt(f"up{i}", hh, ww, cin, f)
        hh, ww = hh * 2, ww * 2
        conv(f"updc{i}/conv0", hh, ww, [f, f], f)
        last = i == n - 1
        conv(f"updc{i}/conv1", hh, ww, [f], f, head=out_channels if last else 0, last=last)
        cin = f
    return calls


def least_s(call: Dict) -> float:
    """A call's least time at the published peaks (seconds)."""
    t_ops = sum(o / PEAKS[p] for p, o in call["ops"].items())
    return max(t_ops, call["bytes"] / HBM_BYTES_PER_S)


def math_s(calls: List[Dict]) -> float:
    """The calls' operations at their precisions' peaks (seconds)."""
    return sum(o / PEAKS[p] for c in calls for p, o in c["ops"].items())


def total_ops(calls: List[Dict]) -> float:
    return sum(o for c in calls for o in c["ops"].values())
