"""The port's int8 modes of K3 (static, dyn, exact with int8 output) and K4
(static) on the CPU, where the wrappers run their plain twins, against the
JAX package's conv_phase kernels in interpret mode through to_phase /
from_phase.

The static modes and K4 must give the same int8 codes: both sides quantise
the weights with the same f32 ops and sum in i32, and the epilogue is one f32
multiply and one f32 add on each side. The exact bf16 conv with int8 output
sums its bf16 products in f32 in another order than the JAX kernel, so a code
may differ by 1 where y lands next to a rounding boundary: at most 1 code on
at most 0.1% of the elements. The dyn mode groups its activation scales by
output pixel (the TPU: by lane over its row window), so it is held to the
JAX test's single-conv budget (tests/test_conv_phase.py:183-222)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtnr_tpu.ops.conv_phase import conv3x3_phase, convt2x2_phase, from_phase, to_phase
from rtnr_tpu_torch.ops import conv as cv

H, W = 8, 32


def _rng(seed):
    return np.random.default_rng(seed)


def codes(shape, seed, lo=-127):
    return _rng(seed).integers(lo, 128, size=shape).astype(np.int8)


def normal(shape, seed, scale=1.0):
    return (_rng(seed).normal(size=shape) * scale).astype(np.float32)


def jphase(a, P, dtype):
    """NHWC numpy -> packed phase-planar JAX array of ``dtype``."""
    return to_phase(jnp.asarray(a.astype(np.float32)), P).astype(dtype)


def assert_codes_close(got: np.ndarray, want: np.ndarray, exact: bool):
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).sum())


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("cs,relu,pool,out", [
    ((16,), True, True, True),  # encoder conv1: ReLU, int8 out, int8 pool
    ((16, 16), True, False, True),  # decoder conv0: [skip, up] at two scales
    ((32,), False, False, True),  # no ReLU: codes clip to [-127, 127]
    ((16,), True, False, False),  # the head conv's input: bf16 out
])
def test_conv3x3_static_gives_jax_codes(P, cs, relu, pool, out):
    F = 32
    qs = [codes((1, H, W, c), 10 + i, 0 if relu else -127) for i, c in enumerate(cs)]
    k = normal((3, 3, sum(cs), F), 1, 0.1)
    b = normal((F,), 2, 0.5)
    s_in = [np.float32(0.031), np.float32(0.047)][: len(cs)]
    s_out = np.float32(0.09) if out else None
    jout = conv3x3_phase(
        [jphase(q, P, jnp.int8) for q in qs], jnp.asarray(k), jnp.asarray(b), h=H, w=W, P=P,
        relu=relu, pool=pool, rows_per_step=2, interpret=True, quant="static",
        in_scales=tuple(jnp.float32(s) for s in s_in),
        out_scale=None if s_out is None else jnp.float32(s_out))
    got = cv.conv3x3([torch.from_numpy(q) for q in qs], k, b, relu=relu, pool=pool,
                     quant="static", in_scales=[torch.tensor(s) for s in s_in],
                     out_scale=None if s_out is None else torch.tensor(s_out))
    assert len(got) == len(jout)
    want = np.asarray(from_phase(jout[0], H, W, F, P))
    if out:
        assert got[0].dtype == torch.int8
        assert_codes_close(got[0].numpy(), want, exact=True)
    else:
        assert got[0].dtype == torch.bfloat16
        np.testing.assert_array_equal(got[0].float().numpy(), want.astype(np.float32))
    if pool:
        wp = np.asarray(from_phase(jout[1], H // 2, W // 2, F, P // 2))
        assert_codes_close(got[1].numpy(), wp, exact=True)
        assert torch.equal(got[1], cv._pool2(got[0]))


def test_conv3x3_static_two_inputs_fold_the_scale_ratio():
    """Folding s_in1/s_in0 into input 1's weight slice before quantising is
    what the JAX kernel does; quantising the two slices on their own is a
    different function, which this pins."""
    C, F = 16, 32
    qa, qb = codes((1, H, W, C), 20, 0), codes((1, H, W, C), 21, 0)
    k = normal((3, 3, 2 * C, F), 22, 0.1)
    s = (torch.tensor(np.float32(0.02)), torch.tensor(np.float32(0.05)))
    w = cv.prepare_conv3x3(k, None, quant="static", in_scales=s, c0=C)
    kf = torch.from_numpy(k).clone()
    kf[:, :, C:] *= s[1] / s[0]
    swv = kf.abs().amax(dim=(0, 1, 2)).clamp_min(1e-12) * cv.INV127
    assert torch.equal(w.wmat[: 9 * 2 * C].float(),
                       torch.clamp(torch.round(kf / swv), -127, 127).reshape(-1, F))
    assert torch.equal(w.scale, swv * s[0])
    with pytest.raises(ValueError, match="c0"):
        cv.prepare_conv3x3(k, None, quant="static", in_scales=s)
    (y,) = cv.conv3x3([torch.from_numpy(qa), torch.from_numpy(qb)], k, None, quant="static",
                      in_scales=s)
    assert y.dtype == torch.bfloat16 and y.shape == (1, H, W, F)  # no out_scale: bf16 out


def test_conv3x3_exact_with_int8_output():
    """down0/conv0 of the static net: the 5-channel bf16 input, int8 out."""
    P, F = 4, 32
    x = normal((1, H, W, 5), 3)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    k, b = normal((3, 3, 5, F), 4, 0.3), normal((F,), 5, 0.3)
    s_out = np.float32(0.021)
    (jy,) = conv3x3_phase([to_phase(jnp.asarray(x).astype(jnp.bfloat16), P)], jnp.asarray(k),
                          jnp.asarray(b), h=H, w=W, P=P, relu=True, rows_per_step=2,
                          interpret=True, out_scale=jnp.float32(s_out))
    want = np.asarray(from_phase(jy, H, W, F, P))
    assert want.dtype == np.int8
    (got,) = cv.conv3x3([xb], k, b, relu=True, out_scale=torch.tensor(s_out))
    assert got.dtype == torch.int8 and int(got.min()) >= 0
    assert_codes_close(got.numpy(), want, exact=False)
    assert (got.numpy() == want).mean() >= 0.999


@pytest.mark.parametrize("P_in", [1, 2])
def test_convt2x2_static_gives_jax_codes(P_in):
    Hh, Wh, C, F = 4, 16, 32, 16
    q = codes((1, Hh, Wh, C), 6)
    k, b = normal((2, 2, C, F), 7, 0.2), normal((F,), 8, 0.4)
    s_in, s_out = np.float32(0.013), np.float32(0.037)
    jy = convt2x2_phase(jphase(q, P_in, jnp.int8), jnp.asarray(k), jnp.asarray(b), h=2 * Hh,
                        w=2 * Wh, P=P_in, rows_per_step=2, interpret=True, quant="static",
                        in_scale=jnp.float32(s_in), out_scale=jnp.float32(s_out))
    want = np.asarray(from_phase(jy, 2 * Hh, 2 * Wh, F, 2 * P_in))
    got = cv.convt2x2(torch.from_numpy(q), k, b, quant="static", in_scale=torch.tensor(s_in),
                      out_scale=torch.tensor(s_out))
    assert got.shape == (1, 2 * Hh, 2 * Wh, F) and got.dtype == torch.int8
    assert_codes_close(got.numpy(), want, exact=True)
    assert int(got.min()) < 0  # no ReLU on the ConvTranspose


@pytest.mark.parametrize("cs,pool", [((16,), False), ((16, 8), True)])
def test_conv3x3_dyn_within_the_single_conv_budget(cs, pool):
    """Against the exact bf16 conv and the JAX dyn conv on the same bf16
    inputs: max <= 0.03 and mean <= 0.005 of the exact output's range."""
    h, w, P, F = 16, 64, 4, 16
    rng = _rng(11 + len(cs))
    xs = [rng.normal(0, 1, (1, h, w, c)).astype(np.float32) for c in cs]
    k = rng.normal(0, 0.1, (3, 3, sum(cs), F)).astype(np.float32)
    b = rng.normal(0, 0.1, (F,)).astype(np.float32)
    jxs = [to_phase(jnp.asarray(x), P) for x in xs]
    kw = dict(h=h, w=w, P=P, relu=True, pool=pool, interpret=True)
    ref = conv3x3_phase(jxs, jnp.asarray(k), jnp.asarray(b), **kw)
    jq = conv3x3_phase(jxs, jnp.asarray(k), jnp.asarray(b), quant=True, **kw)
    txs = [torch.from_numpy(x).to(torch.bfloat16) for x in xs]
    got = cv.conv3x3(txs, k, b, relu=True, pool=pool, quant="dyn")
    a = np.asarray(from_phase(ref[0], h, w, F, P), np.float32)
    q = np.asarray(from_phase(jq[0], h, w, F, P), np.float32)
    g = got[0].float().numpy()
    scale = np.abs(a).max()
    for other in (a, q):
        assert np.abs(g - other).max() <= 0.03 * scale
        assert np.abs(g - other).mean() <= 0.005 * scale
    assert np.all(g[a == 0] <= 0.03 * scale)
    if pool:
        assert torch.equal(got[1], cv._pool2(got[0]))
        ap = np.asarray(from_phase(ref[1], h // 2, w // 2, F, P // 2), np.float32)
        assert np.abs(got[1].float().numpy() - ap).max() <= 0.03 * scale


def test_dyn_scales_are_the_receptive_field_max():
    x = torch.zeros((1, 4, 5, 3), dtype=torch.bfloat16)
    x[0, 2, 3, 1] = -2.5
    inv, s = cv.dyn_scales_plain([x])
    amax = (inv > 0).reshape(4, 5)
    want = torch.zeros(4, 5, dtype=torch.bool)
    want[1:4, 2:5] = True
    assert torch.equal(amax, want)
    assert float(inv.reshape(4, 5)[2, 3]) == np.float32(127.0) / np.float32(2.5)
    assert float(s.reshape(4, 5)[1, 2]) == np.float32(2.5) * np.float32(1.0 / 127.0)


def test_int8_wrappers_take_the_twin_only_on_cpu_and_check_dtypes():
    q = torch.zeros((1, 4, 4, 16), dtype=torch.int8)
    x = torch.zeros((1, 4, 4, 16), dtype=torch.bfloat16)
    one = torch.tensor(0.1)
    counters = (cv.conv3x3_static, cv.conv3x3_dyn, cv.conv3x3_i8out, cv.convt2x2_static)
    before = [c.launches for c in counters]
    cv.conv3x3([q], normal((3, 3, 16, 16), 1), relu=True, quant="static", in_scales=[one],
               out_scale=one)
    cv.conv3x3([x], normal((3, 3, 16, 16), 1), relu=True, quant="dyn")
    cv.conv3x3([x], normal((3, 3, 16, 16), 1), relu=True, out_scale=one)
    cv.convt2x2(q, normal((2, 2, 16, 16), 2), quant="static", in_scale=one, out_scale=one)
    assert [c.launches for c in counters] == before
    with pytest.raises(ValueError, match="int8"):
        cv.conv3x3([x], normal((3, 3, 16, 16), 1), quant="static", in_scales=[one])
    with pytest.raises(ValueError, match="bf16"):
        cv.conv3x3([q], normal((3, 3, 16, 16), 1), quant="dyn")
    with pytest.raises(ValueError, match="quant"):
        cv.conv3x3([x], normal((3, 3, 16, 16), 1), quant="fp8")
    with pytest.raises(ValueError, match="head"):
        cv.conv3x3([x], normal((3, 3, 16, 16), 1), out_scale=one,
                   head_kernel=normal((16, 3), 3))
