"""The fused BatchNorm + ReLU of ``UNetTrain`` (``ops/bn_train.py``): the
plain twins of its four kernels, which repeat the kernels' arithmetic on
plain torch ops, against autograd of the plain layer that the CPU runs, in
f64 and f32. Output, running statistics, dx, dscale and dbias: over one
rank, with a channel whose clipped variance is 0, and over two ranks faked
in one process against ``psum_autograd``'s layer on the concatenated batch.
The kernels themselves are held to these twins on the card
(``tests/test_torch_cuda.py``)."""

import functools

import numpy as np
import pytest
import torch

from rtnr_tpu_torch.ops import bn_train as bt
from rtnr_tpu_torch.parallel.collectives import psum_autograd
from rtnr_tpu_torch.parallel.mesh import make_mesh

SHAPE = (4, 24, 6, 10)  # N, C, H, W; the two faked ranks hold two frames each
CLIPPED = 3  # the channel held constant in the "clipped" case
# largest gap over the largest magnitude of each compared tensor, about ten
# times the largest read: f64 holds the formulas alone (read 4e-16); f32 adds
# the sums' order between ranks and autograd's (read 4e-7)
TOL = {torch.float64: 1e-14, torch.float32: 4e-6}


def _cl(a, dtype):
    """An NCHW tensor with channels-last memory, as UNetTrain's activations."""
    return torch.from_numpy(a).to(dtype).contiguous(memory_format=torch.channels_last)


def _inputs(dtype, case):
    rng = np.random.default_rng(19)
    n, c, h, w = SHAPE
    x = rng.normal(size=SHAPE) * rng.uniform(0.5, 2.0, (1, c, 1, 1)) \
        + rng.uniform(-1.0, 1.0, (1, c, 1, 1))
    if case == "clipped":  # a constant channel whose E[x^2] - E[x]^2 rounds below 0
        for v in np.linspace(0.1037, 3.0, 97):
            x[:, CLIPPED] = v
            _, vraw, _, _ = bt.channel_terms(bt.batch_sums_plain(_cl(x, dtype)),
                                             torch.ones(c, dtype=dtype))
            if float(vraw[CLIPPED]) < 0:
                break
        assert float(vraw[CLIPPED]) < 0
    p = {"scale": rng.uniform(0.5, 1.5, c), "bias": rng.normal(size=c) * 0.3,
         "mean": rng.normal(size=c) * 0.1, "var": rng.uniform(0.5, 1.5, c)}
    return _cl(x, dtype), _cl(rng.normal(size=SHAPE), dtype), \
        {k: torch.from_numpy(v).to(dtype) for k, v in p.items()}


def _truth(x, w, p, reduce):
    """Autograd of the plain layer: (y, dx, dscale, dbias, mean, var)."""
    x = x.detach().clone().requires_grad_(True)
    scale, bias = p["scale"].clone().requires_grad_(True), p["bias"].clone().requires_grad_(True)
    mean, var = p["mean"].clone(), p["var"].clone()
    y = bt.bn_relu_train_plain(x, scale, bias, mean, var, reduce)
    (y * w).sum().backward()
    return y.detach(), x.grad, scale.grad, bias.grad, mean, var


def _twins(xs, ws, p):
    """The kernels' twins over ranks holding ``xs`` (and upstream gradients
    ``ws``), their per-channel vectors summed in rank order as ``psum``
    does: (y, dx, dscale, dbias, mean, var), y and dx concatenated."""
    tot = sum(bt.batch_sums_plain(x) for x in xs)
    mean, var = p["mean"].clone(), p["var"].clone()
    ys = [bt.bn_relu_apply_plain(x, tot, p["scale"], p["bias"], *((mean, var) if r == 0 else ()))
          for r, x in enumerate(xs)]
    parts = [bt.bn_relu_grad_sums_plain(w, x, tot, p["scale"], p["bias"]) for x, w in zip(xs, ws)]
    gsums = sum(s for s, _, _ in parts)
    dxs = [bt.bn_relu_grad_x_plain(w, x, tot, p["scale"], p["bias"], gsums)
           for x, w in zip(xs, ws)]
    return (torch.cat(ys), torch.cat(dxs), sum(d for _, d, _ in parts),
            sum(d for _, _, d in parts), mean, var)


@pytest.mark.parametrize("case", ["one_rank", "clipped", "two_ranks"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_twins_match_autograd_of_the_plain_layer(dtype, case):
    x, w, p = _inputs(dtype, case)
    if case == "one_rank":
        truth = _truth(x, w, p, None)
        twin = _twins([x], [w], p)
    elif case == "clipped":
        truth = _truth(x, w, p, lambda v: v)  # sum / count, as the twins take it
        twin = _twins([x], [w], p)
    else:
        one = functools.partial(psum_autograd, mesh=make_mesh((1, 1)), axis="batch")
        truth = _truth(x, w, p, one)
        twin = _twins([x[:2], x[2:]], [w[:2], w[2:]], p)
    for name, got, want in zip(("y", "dx", "dscale", "dbias", "mean", "var"), twin, truth):
        assert got.dtype == want.dtype and got.shape == want.shape, name
        gap = float((got - want).abs().max()) / float(want.abs().max())
        assert gap <= TOL[dtype], (name, gap)
    if case == "clipped":  # the clip passed no gradient: b = 0 there
        y, xc, (_, vraw, _, mul) = bt._normalised(x, bt.batch_sums_plain(x), p["scale"],
                                                   p["bias"])
        g = torch.where(y > 0, w, 0.0)[:, CLIPPED]
        want = g * mul[CLIPPED] - mul[CLIPPED] * g.sum() / x[:, CLIPPED].numel()
        assert float(vraw[CLIPPED]) < 0
        assert torch.allclose(twin[1][:, CLIPPED], want, rtol=0, atol=TOL[dtype] * float(
            want.abs().max()))


def test_the_kernel_path_rejects_what_the_kernels_do_not_take():
    x = torch.zeros((1, 8, 2, 2))
    v = torch.zeros(8)
    bt._check(x, v, v, v, v)
    bt._check(x.to(torch.bfloat16), v, v, v, v)
    for bad_x, bad_v in ((x.to(torch.float16), v), (x.to(torch.float64), v),
                         (torch.zeros((1, 8, 0, 2)), v), (x, torch.zeros(4)),
                         (x, v.to(torch.float64)), (x, torch.zeros(16)[::2])):
        with pytest.raises(ValueError):
            bt._check(bad_x, bad_v, v, v, v)
