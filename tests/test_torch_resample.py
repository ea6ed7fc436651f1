"""Pyramid resampling (ops/resample.py) against the JAX package's on the
CPU, float32, at tests/test_resample.py's shapes (odd sizes included):

  * down2_blur and up2 within 1e-6 of the JAX convolutions (its
    rs_sfm_tpu/ops/resample.py; float reassociation: a convolution may sum
    its taps in another order);
  * bit-exact to the flow pyramid's formulations they keep, the JAX
    package's `_downsample` and `_up2` (rs_sfm_tpu/flow/dense.py, op by
    op): the same taps summed in the same order;
  * leading axes batch.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rs_sfm_tpu.flow import dense as jdense
from rs_sfm_tpu.ops import resample as jresample
from rs_sfm_tpu_torch.ops import resample as tresample

# The test workers share the CPU with the JAX tests: a few intra-op threads
# each (the results do not depend on the count).
torch.set_num_threads(2)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("shape", [(64, 128), (63, 127), (33, 60),
                                   (24, 64)])
def test_down2_blur_matches_jax(shape):
    x = np.random.default_rng(0).uniform(-1, 1, shape).astype(np.float32)
    got = tresample.down2_blur(torch.from_numpy(x)).numpy()
    assert got.shape == ((shape[0] + 1) // 2, (shape[1] + 1) // 2)
    conv = np.asarray(jresample.down2_blur(jnp.asarray(x)))
    np.testing.assert_allclose(got, conv, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        _bits(got), _bits(np.asarray(jdense._downsample(jnp.asarray(x)))))


@pytest.mark.parametrize("shape", [(64, 128), (63, 127), (17, 33)])
def test_up2_matches_jax(shape):
    x = np.random.default_rng(1).uniform(-1, 1, shape).astype(np.float32)
    got = tresample.up2(torch.from_numpy(x)).numpy()
    assert got.shape == (2 * shape[0], 2 * shape[1])
    conv = np.asarray(jresample.up2(jnp.asarray(x)))
    np.testing.assert_allclose(got, conv, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        _bits(got), _bits(np.asarray(jdense._up2(jnp.asarray(x)))))


@pytest.mark.parametrize("op,shape", [("down2_blur", (3, 40, 64)),
                                      ("up2", (2, 20, 32))])
def test_leading_axes_batch(op, shape):
    x = np.random.default_rng(2).uniform(-1, 1, shape).astype(np.float32)
    got = getattr(tresample, op)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(getattr(jresample, op)(jnp.asarray(x))), rtol=0,
        atol=1e-6)
    for i in range(shape[0]):
        np.testing.assert_array_equal(
            _bits(got[i]),
            _bits(getattr(tresample, op)(torch.from_numpy(x[i])).numpy()))
