"""The U-Net's input conv on Hopper (``csrc/conv_in_sm90.cu``), the parts the
CPU reaches: the route (``conv.takes_in_conv`` / ``conv.k3_route``), the
plain twin that contracts as the kernel walks K (``conv3x3_in_plain``)
against the mode twin at ragged shapes and against the JAX package's
``conv3x3_phase`` in interpret mode (two calls), the kernel's halo and
A-fragment addressing and its output column order mirrored in numpy, and
CPU calls counting nothing."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtnr_tpu.ops.conv_phase import conv3x3_phase, from_phase, to_phase
from rtnr_tpu_torch.ops import conv as cv

TP = 128  # pixels of a kernel tile (conv_in_sm90.cu)


def mk(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("cs,f,kw,head,pool,want", [
    ((5,), 64, {}, False, False, True),  # down0/conv0, bf16 out
    ((5,), 64, {"out_scale": 0.02}, False, False, True),  # the static net's, int8 out
    ((3,), 64, {}, False, False, True),
    ((8,), 64, {}, False, False, True),
    ((1,), 64, {}, False, False, True),
    ((5,), 16, {}, False, False, False),  # narrow test nets
    ((5,), 128, {}, False, False, False),
    ((9,), 64, {}, False, False, False),
    ((5, 5), 64, {}, False, False, False),
    ((5,), 64, {}, True, False, False),  # the head
    ((5,), 64, {}, False, True, False),  # the pool
])
def test_input_conv_route_cases(cs, f, kw, head, pool, want):
    assert cv.takes_in_conv(cs, f, head=head, pool=pool) == want
    w = cv.prepare_conv3x3(mk((3, 3, sum(cs), f), 1, 0.1), mk((f,), 2), c0=cs[0], **kw)
    route = cv.k3_route(cs, w, head=head, pool=pool)
    assert (route == "conv_in_sm90") == want
    if not want:
        assert route == "conv"
    assert w.wmat_t is None  # no K-major copy: the kernel reads wmat


def _ulp_close(got: torch.Tensor, want: torch.Tensor) -> None:
    """Within 1 bf16 ulp of each element's magnitude: the two sum the same
    f32 products in another order. Where an output cancels to near zero the
    f32 difference itself (a few 2^-24 of the largest output) may exceed that
    ulp, so 2^-16 of the largest output is the floor."""
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs())
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(2.0 ** -126))) - 7)
    tol = torch.maximum(ulp, torch.tensor(2.0 ** -16 * float(w.abs().max())))
    assert bool(((g - w).abs() <= tol).all()), float((g - w).abs().max())


@pytest.mark.parametrize("hw", [(1, 1), (3, 37), (17, 130)])
@pytest.mark.parametrize("c", [1, 3, 5, 8])
@pytest.mark.parametrize("out_i8", [False, True])
def test_walk_twin_matches_the_mode_twin(hw, c, out_i8):
    h, w = hw
    x = torch.from_numpy(mk((1, h, w, c), 10 + c)).to(torch.bfloat16)
    kw = {"out_scale": 0.02} if out_i8 else {}
    wp = cv.prepare_conv3x3(mk((3, 3, c, 64), 20 + c, 0.3), mk((64,), 30 + c, 0.5), **kw)
    (got,) = cv.conv3x3_in_plain([x], wp, relu=True)
    (want,) = cv.conv3x3_prepared_plain([x], wp, relu=True)
    assert got.shape == want.shape == (1, h, w, 64) and got.dtype == want.dtype
    if out_i8:
        assert got.dtype == torch.int8 and int(got.min()) >= 0
        assert int((got.int() - want.int()).abs().max()) <= 1
    else:
        _ulp_close(got, want)


@pytest.mark.parametrize("out_scale", [None, 0.021])
def test_walk_twin_against_conv_phase(out_scale):
    """The JAX kernel pads the 5 channels to 8 (to_phase) against zero weight
    rows; bf16 out within the conv tests' 3e-2, int8 out within 1 code on at
    most 0.1% of the elements (tests/test_torch_conv.py,
    tests/test_torch_int8_conv.py)."""
    H, W, C, F, P = 8, 32, 5, 64, 4
    x = mk((1, H, W, C), 3)
    k, b = mk((3, 3, C, F), 4, 0.3), mk((F,), 5, 0.3)
    extra = {} if out_scale is None else {"out_scale": jnp.float32(out_scale)}
    (jy,) = conv3x3_phase([to_phase(jnp.asarray(x).astype(jnp.bfloat16), P)], jnp.asarray(k),
                          jnp.asarray(b), h=H, w=W, P=P, relu=True, rows_per_step=2,
                          interpret=True, **extra)
    want = np.asarray(from_phase(jy, H, W, F, P))
    wp = cv.prepare_conv3x3(k, b, out_scale=None if out_scale is None
                            else torch.tensor(np.float32(out_scale)))
    (got,) = cv.conv3x3_in_plain([torch.from_numpy(x).to(torch.bfloat16)], wp, relu=True)
    if out_scale is None:
        np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32), rtol=3e-2,
                                   atol=3e-2)
    else:
        assert want.dtype == np.int8 and got.dtype == torch.int8
        d = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3


def test_cpu_calls_run_the_twin_and_count_nothing():
    x = torch.from_numpy(mk((1, 6, 20, 5), 40)).to(torch.bfloat16)
    counters = (cv.conv3x3_in, cv.conv3x3, cv.conv3x3_i8out)
    for kw in ({}, {"out_scale": 0.03}):
        w = cv.prepare_conv3x3(mk((3, 3, 5, 64), 41, 0.2), mk((64,), 42), **kw)
        before = [n.launches for n in counters]
        (y,) = cv.conv3x3_prepared([x], w, relu=True)
        assert [n.launches for n in counters] == before
        assert torch.equal(y, cv.conv3x3_prepared_plain([x], w, relu=True)[0])


def _geo(C):
    K = 9 * C
    KS = (K + 16) // 16  # k16 steps over k <= 9C (k = 9C: the bias row)
    L = (TP + 2) * C
    NCH = (L + 14) // 8
    ROWB = NCH * 16
    ZB = 16 * C + 32
    return K, KS, L, NCH, ROWB, ZB, 3 * ROWB, 3 * ROWB + ZB  # ..., ZOFF, OOFF


def _kernel_a(xf, H, W, C, y, x0):
    """The A operand the kernel builds for the tile at (y, x0), mirrored:
    each halo row copied as NCH 16-byte chunks (8 elements) from the
    16-byte boundary at or before its first element, zero where the row or
    the element lies outside (cp.async's source size), its reads starting
    `lead` elements in; a zero region and a region of ones after the rows
    (NaN where nothing is written). Then per warp, lane (g, t), k16 step, k
    pair, fragment row h and element e, the element at the lane's offset:
    on the fast path (an interior tile whose rows share one lead) the first
    row's lead for every element, else each row's lead and zeros at the
    image's left and right edges, recomputed from k; where the fast path
    applies both must agree. Returns (TP, 16*KS) with NaN where no lane
    writes."""
    K, KS, L, NCH, ROWB, ZB, ZOFF, OOFF = _geo(C)
    total = H * W * C
    buf = np.full((OOFF + ZB) // 2, np.nan)
    buf[ZOFF // 2:OOFF // 2] = 0.0
    buf[OOFF // 2:] = 1.0
    lead = []
    for r in range(3):
        yy = y + r - 1
        start = (yy * W + x0 - 1) * C
        lead.append(start & 7)
        for j in range(NCH):
            e0 = (start & ~7) + 8 * j
            for k in range(8):
                e = e0 + k
                ok = 0 <= yy < H and 0 <= e0 < total and e < total
                buf[(r * ROWB) // 2 + 8 * j + k] = xf[e] if ok else 0.0
    fast = x0 >= 1 and x0 + TP < W and lead[0] == lead[1] == lead[2]
    out = np.full((TP, 16 * KS), np.nan)
    for warp in range(TP // 16):
        for g in range(8):
            p0 = warp * 16 + g
            for t in range(4):
                for s in range(4 * KS):
                    k = (s >> 2) * 16 + 2 * t + ((s >> 1) & 1) * 8 + (s & 1)
                    tap, c = divmod(k, C)
                    dy, dx = divmod(tap, 3)
                    off = (dy * ROWB + ((p0 + dx) * C + c) * 2 if k < K
                           else (OOFF if k == K else ZOFF))
                    for h in range(2):
                        o = off + h * 16 * C
                        lb = lead[0] if k >= K else lead[dy]
                        xx = x0 - 1 + p0 + 8 * h + dx
                        slow = buf[(2 * lb + o) // 2] if k >= K or 0 <= xx < W else 0.0
                        if fast:
                            v = buf[(2 * lead[0] + o) // 2]
                            assert v == slow or (np.isnan(v) and np.isnan(slow))
                        else:
                            v = slow
                        assert np.isnan(out[p0 + 8 * h, k])
                        out[p0 + 8 * h, k] = v
    return out


@pytest.mark.parametrize("c", [1, 3, 5, 8])
@pytest.mark.parametrize("w", [1, 37, 130, 300, 320])
def test_halo_and_a_fragment_addressing(c, w):
    """Every tile's A operand, as the kernel's aligned halo spans, leads,
    offsets and edge masks build it, equals the im2col of the input
    (tap-major K, zeros past the image), then a column of ones (the bias
    row's partner) and zeros, on the tile's pixels inside the image. W = 320
    gives interior tiles on the fast path at every C (W*C % 8 == 0)."""
    H = 3
    K, KS = 9 * c, (9 * c + 16) // 16
    xf = np.arange(1, H * w * c + 1, dtype=np.float64)  # distinct, non-zero
    xp = np.pad(xf.reshape(H, w, c), ((1, 1), (1, 1), (0, 0)))
    for y in range(H):
        for x0 in range(0, w, TP):
            a = _kernel_a(xf, H, w, c, y, x0)
            n = min(TP, w - x0)
            cols = np.concatenate([xp[y + dy, x0 + dx:x0 + dx + n] for dy in range(3)
                                   for dx in range(3)], axis=-1)
            assert np.array_equal(a[:n, :K], cols)
            assert (a[:, K] == 1).all() and (a[:, K + 1:] == 0).all()


def _out_channel(n, i8):
    """The kernel's GEMM column -> output channel map (out_channel)."""
    nb, t, e = n >> 3, (n >> 1) & 3, n & 1
    if i8:
        return 16 * t + 2 * nb + e
    return (8 * t + 2 * nb if nb < 4 else 32 + 8 * t + 2 * (nb - 4)) + e


@pytest.mark.parametrize("i8", [False, True])
def test_output_columns_make_whole_stores(i8):
    """The GEMM columns a lane t holds (8nb + 2t + e) map one to one onto
    the 64 channels, as runs the lane stores 16 bytes at a time: int8, the
    16 channels 16t.. in order; bf16, 8t.. (nb < 4) and 32 + 8t.. (nb >= 4).
    Together the four lanes of a pixel cover it whole (int8) or each half
    (bf16) with one store each."""
    assert sorted(_out_channel(n, i8) for n in range(64)) == list(range(64))
    runs = []
    for t in range(4):
        chans = [_out_channel(nb * 8 + 2 * t + e, i8) for nb in range(8) for e in range(2)]
        parts = [chans] if i8 else [chans[:8], chans[8:]]
        for part in parts:
            assert part == list(range(part[0], part[0] + len(part)))
            assert (part[0] * (1 if i8 else 2)) % 16 == 0  # 16-byte aligned store
        runs.append(parts)
    for j in range(len(runs[0])):
        starts = sorted(runs[t][j][0] for t in range(4))
        width = len(runs[0][j])
        assert starts == list(range(starts[0], starts[0] + 4 * width, width))
