"""K3's fused-ConvTranspose mode (``conv3x3(..., up_kernel=, up_bias=)``,
JAX's ``conv3x3_phase(up_kernel=)``) and the U-Net's fused branch under
``RTNR_FUSE_UP=1`` (``rtnr_tpu/models/unet.py:578-588, 654-707``), as the
CPU reaches them: the wrapper runs its plain twin here, the pair of unfused
twins. Tolerance against JAX: rtol/atol 3e-2, as tests/test_torch_conv.py
(bf16 outputs, f32 sums in another order). One interpret-mode call."""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtnr_tpu.ops.conv_phase import conv3x3_phase, from_phase, to_phase
from rtnr_tpu.ops.conv_phase import fuse_up_ok as j_fuse_up_ok
from rtnr_tpu_torch.models import unet as tu
from rtnr_tpu_torch.models.convert import from_flax_variables, init_unet_numpy
from rtnr_tpu_torch.ops import conv as cv

TOL = dict(rtol=3e-2, atol=3e-2)
FEAT = (8, 16)
H = W = 32


def mk(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def test_fused_conv_matches_conv_phase_interpret():
    """The port's fused call against JAX's fused kernel, at
    tests/test_conv_phase.py:160's shapes, P_in = 1."""
    Hh, Wh, Cd, F, P_in = 4, 16, 16, 8, 1
    deep, skip = mk((1, Hh, Wh, Cd), 21), mk((1, 2 * Hh, 2 * Wh, F), 22)
    kt, bt = mk((2, 2, Cd, F), 23, 0.3), mk((F,), 24)
    kernel, b = mk((3, 3, 2 * F, F), 25, 0.2), mk((F,), 26)
    to_j = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    (want,) = conv3x3_phase([to_phase(to_j(skip), 2 * P_in), to_phase(to_j(deep), P_in)],
                            jnp.asarray(kernel), jnp.asarray(b), up_kernel=jnp.asarray(kt),
                            up_bias=jnp.asarray(bt), h=2 * Hh, w=2 * Wh, P=2 * P_in, relu=True,
                            rows_per_step=2, interpret=True)
    (got,) = cv.conv3x3([_bf16(skip), _bf16(deep)], kernel, b, relu=True, up_kernel=kt,
                        up_bias=bt)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 2 * Hh, 2 * Wh, F)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(from_phase(want, 2 * Hh, 2 * Wh, F, 2 * P_in),
                                          np.float32), **TOL)


@pytest.mark.parametrize("hh,wh,cs,cd,f", [(4, 16, 8, 16, 8), (3, 5, 64, 128, 64),
                                           (2, 3, 128, 256, 128), (3, 4, 16, 64, 32)])
def test_fused_twin_equals_unfused_twins(hh, wh, cs, cd, f):
    """The fused call is convt2x2 then the two-input conv3x3, bit for bit,
    with the up pixels past the image the conv's zero padding."""
    deep, skip = _bf16(mk((1, hh, wh, cd), 30)), _bf16(mk((1, 2 * hh, 2 * wh, cs), 31))
    kt, bt = mk((2, 2, cd, f), 32, 0.1), mk((f,), 33)
    kernel, b = mk((3, 3, cs + f, f), 34, 0.05), mk((f,), 35)
    (got,) = cv.conv3x3([skip, deep], kernel, b, relu=True, up_kernel=kt, up_bias=bt)
    up = cv.convt2x2(deep, kt, bt)
    (want,) = cv.conv3x3([skip, up], kernel, b, relu=True)
    assert torch.equal(got, want)
    w, uw = cv.prepare_conv3x3(kernel, b), cv.prepare_convt2x2(kt, bt)
    (twin,) = cv.conv3x3_prepared_plain([skip, deep], w, relu=True, up=uw)
    assert torch.equal(twin, want)


def test_fused_mode_refuses_what_it_does_not_take():
    deep, skip = _bf16(mk((1, 2, 4, 16), 40)), _bf16(mk((1, 4, 8, 8), 41))
    kt, kernel = mk((2, 2, 16, 8), 42), mk((3, 3, 16, 8), 43)
    for kw in (dict(pool=True), dict(head_kernel=mk((8, 3), 44))):
        with pytest.raises(ValueError, match="bf16 only"):
            cv.conv3x3([skip, deep], kernel, relu=True, up_kernel=kt, **kw)
    with pytest.raises(ValueError, match="not the"):
        cv.conv3x3([skip, skip], kernel, relu=True, up_kernel=mk((2, 2, 8, 8), 45))
    with pytest.raises(ValueError, match="skip, deep"):
        cv.conv3x3([skip], kernel, relu=True, up_kernel=kt)


@pytest.mark.parametrize("cs,cd,cu,f,want", [
    (64, 128, 64, 64, True),  # updc3 at full width
    (128, 256, 128, 128, True),  # updc2
    (256, 512, 256, 256, False),  # one tile would not hold every channel
    (64, 128, 64, 128, False),  # C_up != F
    (8, 16, 8, 8, False),  # toy widths: the card runs K4 then K3
    (64, 96, 64, 64, False),
])
def test_route(cs, cd, cu, f, want):
    assert cv.takes_up(cs, cd, cu, f) == want


def test_up_k_major_copy_follows_the_kernel_row_map():
    """Row (u*4 + dy*2 + dx)*64 + j of the up GEMM's B holds
    kernel[1-dy, 1-dx, :, 64u + j] in bf16."""
    cd, f = 128, 128
    kt = mk((2, 2, cd, f), 50, 0.1)
    uw = cv.prepare_convt2x2(kt, mk((f,), 51))
    assert uw.wmat_t.shape == (4 * f, cd) and uw.wmat_t.is_contiguous()
    kb = torch.from_numpy(kt).to(torch.bfloat16)
    for u in range(f // 64):
        for dy in range(2):
            for dx in range(2):
                row = (u * 4 + dy * 2 + dx) * 64
                want = kb[1 - dy, 1 - dx, :, 64 * u:64 * u + 64].t()
                assert torch.equal(uw.wmat_t[row:row + 64], want)
    assert cv.prepare_convt2x2(mk((2, 2, 16, 8), 52)).wmat_t is None
    # static weights keep the GEMM's column order (the int8 K4 kernel's B)
    sw = cv.prepare_convt2x2(mk((2, 2, 64, 64), 53), quant="static", in_scale=0.1)
    assert torch.equal(sw.wmat_t, sw.wmat[:64].t())


@pytest.mark.parametrize("F", [8, 16, 64, 128])
def test_fuse_up_ok_equals_jax(F):
    for h in (2, 4, 6, 8, 16, 24, 34, 68, 136, 272, 544, 720, 1088, 1440):
        for P in (1, 2, 4, 8, 16, 32):
            for c in (F // 2, F, 2 * F):
                for cd in (F, 2 * F, 4 * F):
                    args = (h, P, c, c, cd, F)
                    assert cv.fuse_up_ok(*args) == j_fuse_up_ok(*args), args


def _jax_fused_levels(features, h):
    """The levels ``_phase_forward`` fuses (``unet.py:654-671``), from
    JAX's own ``fuse_up_ok``."""
    n = len(features)
    P, hs, cc, out = 1, h >> n, 2 * features[-1], set()
    for i, f in enumerate(reversed(features)):
        hs *= 2
        if j_fuse_up_ok(hs, 2 * P, f, f, cc, f):
            out.add(i)
        P *= 2
        cc = f
    return out


@pytest.mark.parametrize("h", [720, 1088, 1440])
def test_full_width_fuses_levels_2_and_3(h):
    feat = (64, 128, 256, 512)
    net = types.SimpleNamespace(features=feat)  # fuse_levels reads only the widths
    assert tu.UNet.fuse_levels(net, h) == _jax_fused_levels(feat, h) == {2, 3}


@pytest.fixture
def recorder(monkeypatch):
    """Record every conv3x3_prepared call of the U-Net: (name of the
    weights' mode, whether it fused the ConvTranspose)."""
    calls = []
    real = tu.conv3x3_prepared

    def rec(xs, w, **kw):
        calls.append((w.quant, kw.get("up") is not None))
        return real(xs, w, **kw)

    monkeypatch.setattr(tu, "conv3x3_prepared", rec)
    return calls


def _net(**kw):
    return tu.UNet(from_flax_variables(init_unet_numpy(0, FEAT)), features=FEAT, **kw)


def _x():
    return torch.from_numpy(np.random.default_rng(1).standard_normal((1, H, W, 5))
                            .astype(np.float32))


def test_unet_fused_equals_unfused_bf16(monkeypatch, recorder):
    net, x = _net(), _x()
    monkeypatch.delenv("RTNR_FUSE_UP", raising=False)
    want = net(x)
    assert recorder and not any(up for _, up in recorder)
    recorder.clear()
    monkeypatch.setenv("RTNR_FUSE_UP", "1")
    assert net.fuse_levels(H) == _jax_fused_levels(FEAT, H) == {0, 1}
    got = net(x)
    assert sum(up for _, up in recorder) == 2 and torch.equal(got, want)
    monkeypatch.setenv("RTNR_FUSE_UP", "0")
    recorder.clear()
    assert torch.equal(net(x), want) and not any(up for _, up in recorder)


def test_dyn_fused_levels_run_conv0_in_bf16(monkeypatch, recorder):
    """quant_min_f=1: on the levels JAX fuses, conv0 is exact bf16 and conv1
    dyn; the prepared plan follows the variable at each forward."""
    net, x = _net(quant_int8=True, quant_min_f=1), _x()
    monkeypatch.setenv("RTNR_FUSE_UP", "1")
    fused = net.fuse_levels(H)
    assert fused == _jax_fused_levels(FEAT, H)
    plan = net.int8_plan(None, fused)
    for i in range(len(FEAT)):
        assert plan[f"updc{i}/conv0"] == ({} if i in fused else {"quant": "dyn"})
        assert plan[f"updc{i}/conv1"] == {"quant": "dyn"}
    y = net(x)
    # encoder 4 + bottleneck 2 + decoder (fused conv0, conv1) x 2
    assert [c for c in recorder if c[1]] == [("", True)] * len(fused)
    assert sum(q == "dyn" for q, _ in recorder) == 3 + 2 + len(FEAT)
    assert torch.equal(net.forward_plain(x), y)
    monkeypatch.delenv("RTNR_FUSE_UP")
    recorder.clear()
    y0 = net(x)
    assert not any(up for _, up in recorder) and not torch.equal(y0, y)
    assert sum(q == "dyn" for q, _ in recorder) == 3 + 2 + 2 * len(FEAT)


def test_static_and_calibration_never_fuse(monkeypatch, recorder):
    monkeypatch.setenv("RTNR_FUSE_UP", "1")
    x = _x()
    scales = tu.calibrate_act_scales(_net(), x)
    assert len(scales) == 11 and {"u0t", "u1t"} <= set(scales)
    assert recorder and not any(up for _, up in recorder)
    net = _net(quant_int8=True, quant_min_f=1)
    recorder.clear()
    net(x, act_scales=scales)
    assert recorder and not any(up for _, up in recorder)


# ---- a numpy mirror of conv_sm90.cu's fused tile (conv3x3_up_wgmma) ----

def _src_define(name):
    from rtnr_tpu_torch import _build

    src = (_build.SRC_DIR / "conv_sm90.cu").read_text()
    return int(src.split(f"#define {name} ")[1].split()[0])


def _grid_values(shape, seed, scale):
    """Small integers times a power of two: every f32 sum below is exact,
    so the mirror's and the twin's different orders give the same bits."""
    return (np.random.default_rng(seed).integers(-2, 3, shape) * scale).astype(np.float32)


def mirror_up_tile(deep, uw, H, W, x0, y0, cw):
    """Consumer ``cw``'s up tile of the tile at (x0, y0): the up GEMM of the
    6 x 10 deep pixels at box rows 4cw .. 4cw+5 (60 of the m64) against the
    256 columns of ``uw.wmat_t`` a 64-channel chunk u (subpixel, channel),
    then bias, bf16, zeros outside the image, each value placed at (ur, uc)
    as the kernel's epilogue places it. Returns the (UT_H, UT_W, F) tile and
    how often each pixel of it was written."""
    ty, tx, dx_, uh, uw_ = (_src_define(k) for k in ("UT_Y", "TILE_X", "DEEP_X", "UT_H", "UT_W"))
    assert (ty, tx, dx_, uh, uw_) == (16, 16, 10, 10, 18)
    hh, wh, cd = deep.shape
    F = uw.f
    wt = uw.wmat_t.float().numpy()
    ut = np.full((uh, uw_, F), np.nan, np.float32)
    writes = np.zeros((uh, uw_), np.int64)
    for m in range(64):
        dr, dc = m // dx_, m % dx_
        gy, gx = y0 // 2 - 1 + 4 * cw + dr, x0 // 2 - 1 + dc  # the TMA box's deep pixel
        row = deep[gy, gx] if 0 <= gy < hh and 0 <= gx < wh else np.zeros(cd, np.float32)
        if m >= 6 * dx_:
            continue
        n = np.arange(256)  # the accumulator's columns: subpixel (sy, sx), channel j
        sy, sx, j = n // 128, (n // 64) & 1, n % 64
        ur, uc = 2 * dr + sy - 1, 2 * dc + sx - 1
        keep = (ur >= 0) & (ur < uh) & (uc >= 0) & (uc < uw_)
        uy, ux = y0 + 8 * cw - 1 + ur, x0 - 1 + uc
        inside = (uy >= 0) & (uy < H) & (ux >= 0) & (ux < W)
        for u in range(F // 64):
            acc = wt[256 * u:256 * u + 256] @ row  # the m64n256 row m, f32 (exact here)
            v = np.where(inside, acc + uw.bias.numpy()[64 * u + j], 0.0).astype(np.float32)
            v = torch.from_numpy(v).to(torch.bfloat16).float().numpy()
            ut[ur[keep], uc[keep], 64 * u + j[keep]] = v[keep]
            np.add.at(writes, (ur[keep & (j == 0)], uc[keep & (j == 0)]), 1)
    return ut, writes // (F // 64)


def a_rows(start, sbo_rows):
    """The 64 rows an m64 wgmma operand reads from a descriptor that starts
    at row ``start`` (of 128 bytes) with 8-row groups ``sbo_rows`` apart:
    row i is start + (i // 8) * sbo_rows + i % 8."""
    i = np.arange(64)
    return start + (i // 8) * sbo_rows + i % 8


@pytest.mark.parametrize("hw,cs,cd,f", [((14, 18), 64, 128, 64), ((14, 18), 128, 256, 128),
                                        ((34, 50), 64, 128, 64), ((34, 50), 128, 256, 128)])
def test_mirror_of_the_fused_tile(hw, cs, cd, f):
    """At both fused levels' channel counts on ragged images: every up pixel
    of each consumer's tile is written once and holds the twin's up value
    (the conv's zero padding outside the image); each stage's A operand,
    addressed as the kernel's descriptors address it (m64 block mb = the
    8 x 8 pixels at rows 8cw.., columns 8mb..; the halo box at 16 pixels a
    row, the up tile at 18, started at the tap's shift), reads the pixel the
    conv needs; the tile's conv walked in the kernel's order, stored as its
    8 x 8 TMA boxes, equals the fused twin."""
    H, W = hw
    skip = _grid_values((H, W, cs), 60, 0.25)
    deep = _grid_values((H // 2, W // 2, cd), 61, 0.25)
    kt, bt = _grid_values((2, 2, cd, f), 62, 0.125), _grid_values((f,), 63, 0.5)
    kernel, b = _grid_values((3, 3, cs + f, f), 64, 0.125), _grid_values((f,), 65, 0.5)
    uw, w = cv.prepare_convt2x2(kt, bt), cv.prepare_conv3x3(kernel, b)
    up = cv.convt2x2_prepared_plain(_bf16(deep)[None], uw)[0].float().numpy()
    up_pad = np.pad(up, ((1, 17), (1, 17), (0, 0)))  # zeros past the image
    skip_pad = np.pad(skip, ((1, 17), (1, 17), (0, 0)))  # the TMA box's zeros
    (want,) = cv.conv3x3_prepared_plain([_bf16(skip)[None], _bf16(deep)[None]], w, relu=True,
                                        up=uw)
    wt = w.wmat_t.float().numpy()  # (F, 9 (cs + F)): tap (dy, dx) at (3dy + dx) * ct
    ct = cs + f
    tx, ut_w = _src_define("TILE_X"), _src_define("UT_W")
    got = np.zeros((H, W, f), np.float32)
    for y0 in range(0, H, 16):
        for x0 in range(0, W, 16):
            for cw in range(2):
                ut, writes = mirror_up_tile(deep, uw, H, W, x0, y0, cw)
                assert (writes == 1).all()
                # the up tile against the twin's up tensor around the band
                np.testing.assert_array_equal(ut, up_pad[y0 + 8 * cw:y0 + 8 * cw + 10,
                                                         x0:x0 + 18])
                ut_rows = ut.reshape(-1, f)
                acc = np.zeros((2, 64, f), np.float32)
                for dx in range(3):
                    # the halo box of this dx: image rows y0-1 .., columns x0+dx-1 ..
                    box = skip_pad[y0:y0 + 18, x0 + dx:x0 + dx + tx].reshape(-1, cs)
                    for dy in range(3):
                        k = (3 * dy + dx) * ct
                        for mb in range(2):
                            rows = a_rows((8 * cw + dy) * tx + 8 * mb, tx)
                            acc[mb] += box[rows] @ wt[:, k:k + cs].T
                    for dy in range(3):
                        k = (3 * dy + dx) * ct + cs
                        for mb in range(2):
                            rows = a_rows(dy * ut_w + 8 * mb + dx, ut_w)
                            acc[mb] += ut_rows[rows] @ wt[:, k:k + f].T
                for mb in range(2):
                    # the TMA store of block mb: rows y0 + 8cw .., columns x0 + 8mb ..
                    out = np.maximum(acc[mb] + w.bias.numpy(), 0).reshape(8, 8, f)
                    ya, xa = y0 + 8 * cw, x0 + 8 * mb
                    yb, xb = min(ya + 8, H), min(xa + 8, W)
                    if ya < H and xa < W:
                        got[ya:yb, xa:xb] = out[:yb - ya, :xb - xa]
    assert torch.equal(torch.from_numpy(got).to(torch.bfloat16), want[0])
