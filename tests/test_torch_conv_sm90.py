"""K3's exact bf16 mode on Hopper (``csrc/conv_sm90.cu``), the parts the CPU
reaches: the route (``conv.takes_wgmma``) over the full-width U-Net's convs
and K10's, the kernel's plain twin (``conv.conv3x3_wgmma_plain``, which
contracts as the kernel walks K) against the JAX package's ``conv3x3_phase``
in interpret mode and against the f32 conv, and the K-major weight copy the
kernel reads. Tolerance against JAX: atol/rtol 3e-2, as
tests/test_torch_conv.py states (bf16 outputs, f32 sums in another order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtnr_tpu.ops.conv_phase import conv3x3_phase, from_phase, to_phase
from rtnr_tpu_torch.models.convert import unet_layer_names
from rtnr_tpu_torch.ops import conv as cv

TOL = dict(rtol=3e-2, atol=3e-2)
FEATURES = (64, 128, 256, 512)


def mk(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def unet_conv_calls(features=FEATURES, in_ch=5):
    """(name, input channel counts, F, head) of every conv3x3 of the U-Net,
    in forward order (``UNet._run``'s topology)."""
    n = len(features)
    calls, c = {}, in_ch
    for i, f in enumerate(features):
        calls[f"down{i}/conv0"] = ((c,), f, False)
        calls[f"down{i}/conv1"] = ((f,), f, False)
        c = f
    fb = 2 * features[-1]
    calls["bottleneck/conv0"] = ((features[-1],), fb, False)
    calls["bottleneck/conv1"] = ((fb,), fb, False)
    for i, f in enumerate(reversed(features)):
        calls[f"updc{i}/conv0"] = ((f, f), f, False)  # [skip, up]
        calls[f"updc{i}/conv1"] = ((f,), f, i == n - 1)
    convs, _ = unet_layer_names(n)
    return [(name,) + calls[name] for name in convs]


def test_route_takes_every_unet_conv_but_the_input_conv():
    calls = unet_conv_calls()
    assert len(calls) == 18
    routed = [name for name, cs, f, head in calls if cv.takes_wgmma(cs, f, head=head)]
    assert len(routed) == 17 and "down0/conv0" not in routed


@pytest.mark.parametrize("cs,f,kw,want", [
    ((64, 64), 64, {}, True),  # K10 at the decoder's finest level
    ((64,), 64, {"head": True}, True),  # the last conv with the fused head
    ((64,), 128, {"head": True}, True),
    ((5,), 64, {}, False),  # the U-Net's input conv
    ((5,), 64, {"out_i8": True}, False),  # the static net's input conv
    ((64,), 64, {"out_i8": True}, False),
    ((64,), 64, {"quant": "static"}, False),
    ((64,), 64, {"quant": "dyn"}, False),
    ((8,), 16, {}, False),  # narrow test nets
    ((16, 16), 16, {}, False),
    ((64, 32), 64, {}, False),
    ((64,), 32, {}, False),
    ((64,), 256, {"head": True}, False),  # the head needs one tile to hold every channel
])
def test_route_cases(cs, f, kw, want):
    assert cv.takes_wgmma(cs, f, **kw) == want


def _inputs(cs, f, seed, h=20, w=36):
    """Ragged-size bf16 inputs (neither 8 nor 16 divides 20x36 both ways)
    as (jax, torch) pairs, the kernel and the bias."""
    xs = [mk((1, h, w, c), seed + i) for i, c in enumerate(cs)]
    pairs = [(jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16))
             for x in xs]
    return pairs, mk((3, 3, sum(cs), f), seed + 7, 0.05), mk((f,), seed + 8)


def close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL)


@pytest.mark.parametrize("cs,f,pool", [((64,), 64, True), ((64, 64), 128, False),
                                       ((64, 64), 64, True)])
def test_twin_matches_conv_phase_interpret(cs, f, pool):
    """The K-walk twin against the TPU kernel (interpret mode), with the
    fused pool, at 20x36 with one input and two."""
    H, W, P = 20, 36, 2
    pairs, kernel, b = _inputs(cs, f, 40)
    outs = conv3x3_phase([to_phase(xj, P) for xj, _ in pairs], jnp.asarray(kernel),
                         jnp.asarray(b), h=H, w=W, P=P, relu=True, pool=pool, rows_per_step=4,
                         interpret=True)
    w = cv.prepare_conv3x3(kernel, b)
    got = cv.conv3x3_wgmma_plain([xt for _, xt in pairs], w, relu=True, pool=pool)
    assert got[0].dtype == torch.bfloat16 and got[0].shape == (1, H, W, f)
    close(got[0], from_phase(outs[0], H, W, f, P))
    if pool:
        close(got[1], from_phase(outs[1], H // 2, W // 2, f, P // 2))
        assert torch.equal(got[1], cv._pool2(got[0]))


def test_twin_fused_head_matches_conv_phase_interpret():
    H, W, P, F2 = 20, 36, 2, 3
    pairs, kernel, b = _inputs((64,), 64, 50)
    hk, hb = mk((64, F2), 51, 0.3), mk((F2,), 52)
    (out,) = conv3x3_phase([to_phase(xj, P) for xj, _ in pairs], jnp.asarray(kernel),
                           jnp.asarray(b), head_kernel=jnp.asarray(hk),
                           head_bias=jnp.asarray(hb), h=H, w=W, P=P, relu=True,
                           rows_per_step=4, interpret=True)
    head = cv.prepare_head(hk, hb)
    (got,) = cv.conv3x3_wgmma_plain([pairs[0][1]], cv.prepare_conv3x3(kernel, b), relu=True,
                                    head=head)
    assert got.shape == (1, H, W, F2)
    close(got, from_phase(out, H, W, 8, P)[..., :F2])


@pytest.mark.parametrize("cs,f,pool,head", [((64,), 64, False, False), ((64, 64), 128, True, False),
                                            ((128, 64), 64, False, True),
                                            ((64,), 192, True, False)])
def test_twin_equals_f32_conv(cs, f, pool, head):
    """In f32 the K-walk twin is the f32 conv up to f32 rounding: the same
    products summed in another order."""
    pairs, kernel, b = _inputs(cs, f, 60)
    w = cv.prepare_conv3x3(kernel, b)
    xs = [xt for _, xt in pairs]
    kb = w.wmat[:9 * sum(cs)].to(torch.float32).reshape(3, 3, sum(cs), f)
    hd = cv.prepare_head(mk((f, 5), 61, 0.2), mk((5,), 62)) if head else None
    got = cv.conv3x3_wgmma_plain(xs, w, relu=True, pool=pool, head=hd, dtype=torch.float32)
    want = cv.conv3x3_plain(xs, kb, w.bias, relu=True, pool=pool,
                            head_kernel=None if hd is None else hd.hk.float(),
                            head_bias=None if hd is None else hd.hb, dtype=torch.float32)
    assert len(got) == len(want)
    for g, r in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == r.shape
        scale = float(r.abs().max())
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0, atol=1e-5 * scale)


def test_k_major_copy_follows_the_kernel_row_map():
    """Row ``t*(C0+C1) + (C0 if input 1) + c`` of the K walk holds
    kernel[t // 3, t % 3, channel, :] in bf16, as ``wmat`` does."""
    c0, c1, f = 64, 128, 128
    kernel, b = mk((3, 3, c0 + c1, f), 70, 0.1), mk((f,), 71)
    w = cv.prepare_conv3x3(kernel, b)
    assert w.wmat_t.shape == (f, 9 * (c0 + c1)) and w.wmat_t.dtype == torch.bfloat16
    assert w.wmat_t.is_contiguous()
    kb = torch.from_numpy(kernel).to(torch.bfloat16)
    rng = np.random.default_rng(72)
    for _ in range(64):
        t, i, n = int(rng.integers(9)), int(rng.integers(2)), int(rng.integers(f))
        c = int(rng.integers(c1 if i else c0))
        row = t * (c0 + c1) + (c0 if i else 0) + c
        assert w.wmat_t[n, row] == kb[t // 3, t % 3, (c0 if i else 0) + c, n]
    assert torch.equal(w.wmat_t, w.wmat[:9 * (c0 + c1)].t())


@pytest.mark.parametrize("c,f,kw", [(5, 64, {}), (64, 32, {}), (64, 64, {"out_scale": 0.5}),
                                    (32, 64, {"quant": "static", "in_scales": (0.1,)}),
                                    (64, 64, {"quant": "dyn"})])
def test_no_k_major_copy_where_the_kernel_is_not_routed(c, f, kw):
    w = cv.prepare_conv3x3(mk((3, 3, c, f), 80, 0.1), mk((f,), 81), **kw)
    assert w.wmat_t is None


def test_cpu_calls_run_the_twin_and_count_nothing():
    pairs, kernel, b = _inputs((64,), 64, 90, h=8, w=16)
    xs = [xt for _, xt in pairs]
    w = cv.prepare_conv3x3(kernel, b)
    before = (cv.conv3x3_wgmma.launches, cv.conv3x3.launches)
    y, pooled = cv.conv3x3_prepared(xs, w, relu=True, pool=True)
    assert (cv.conv3x3_wgmma.launches, cv.conv3x3.launches) == before
    want = cv.conv3x3_prepared_plain(xs, w, relu=True, pool=True)
    assert torch.equal(y, want[0]) and torch.equal(pooled, want[1])


def test_head_rows_pad_to_eight():
    hd = cv.prepare_head(mk((64, 3), 95), mk((3,), 96))
    assert hd.hk8.shape == (64, 8) and hd.hk8.dtype == torch.bfloat16
    assert torch.equal(hd.hk8[:, :3], hd.hk) and not bool(hd.hk8[:, 3:].any())
    assert cv.prepare_head(mk((64, 9), 97)).hk8 is None
