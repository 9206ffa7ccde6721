"""The direct 3x3 conv (K10's counterpart, ops/conv_direct.py) against JAX
``conv3x3_pallas`` in interpret mode, at the shapes of
tests/test_foils.py:75-83: one and two inputs, with and without bias and
ReLU, and a batch of two. Tolerance: one bf16 ulp of each element (the
larger of the two magnitudes), since f32 sums in another order can flip one
bf16 rounding. Inputs come from numpy seeds."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtnr_tpu.ops.conv_pallas import conv3x3_pallas as j_conv3x3_pallas
from rtnr_tpu_torch.ops import conv as cv
from rtnr_tpu_torch.ops.conv_direct import conv3x3_pallas


def _bf16_ulp(a: np.ndarray) -> np.ndarray:
    """bf16 spacing at each |a| (the smallest normal's below it)."""
    e = np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("n,cs,bias,relu", [
    (1, (16, 16), True, True),
    (1, (16, 16), False, False),
    (1, (32,), True, True),
    (1, (32,), False, False),
    (2, (32,), False, False),  # the batch runs image by image, as on the TPU
])
def test_conv3x3_pallas_matches_jax_interpret(n, cs, bias, relu):
    rng = np.random.default_rng(0)
    h, w, f = 8, 16, 16
    xs = [rng.normal(size=(n, h, w, c)).astype(np.float32) for c in cs]
    kernel = (rng.normal(size=(3, 3, sum(cs), f)) * 0.2).astype(np.float32)
    b = rng.normal(size=(f,)).astype(np.float32) if bias else None
    want = j_conv3x3_pallas([jnp.asarray(x, jnp.bfloat16) for x in xs], jnp.asarray(kernel),
                            None if b is None else jnp.asarray(b), relu=relu,
                            rows_per_step=2, interpret=True)
    want = np.asarray(want, np.float32)
    before = (conv3x3_pallas.launches, cv.conv3x3.launches)
    got = conv3x3_pallas([torch.from_numpy(x) for x in xs], torch.from_numpy(kernel),
                         None if b is None else torch.from_numpy(b), relu=relu)
    assert (conv3x3_pallas.launches, cv.conv3x3.launches) == before  # CPU: the twin
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (n, h, w, f)
    got = got.float().numpy()
    tol = _bf16_ulp(np.maximum(np.abs(want), np.abs(got)))
    assert np.all(np.abs(got - want) <= tol), float(np.max(np.abs(got - want) - tol))
    if relu:
        assert got.min() >= 0.0
