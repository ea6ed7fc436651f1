"""9-point minimal solver and its small linear algebra: rs_sfm_tpu_torch vs
the JAX package in float64, to the PARITY.md bounds (w ≤ 2.3e-10,
v ≤ 2.3e-9 sign-aligned)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rs_sfm_tpu.ops import linalg as jlinalg
from rs_sfm_tpu.solver import minimal as jmin
from rs_sfm_tpu.solver.beta import get_alpha, get_alpha_k
from rs_sfm_tpu.solver.flow_model import predict_flow
from rs_sfm_tpu_torch.ops import linalg as tlinalg
from rs_sfm_tpu_torch.solver import minimal as tmin

# The test workers share the CPU with the JAX tests: a few intra-op threads
# each (the results do not depend on the count).
torch.set_num_threads(2)

W_TOL = 2.3e-10
V_TOL = 2.3e-9
B = 64

# Jitted once per shape: eager JAX retraces the Jacobi loops on every call.
_jax_velocities = jax.jit(jmin.calculate_velocities, static_argnums=(4,))
_jax_eigh = jax.jit(jlinalg.eigh_small)
_jax_null = jax.jit(jlinalg.null_vector)


def _random_samples(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(scale=0.4, size=(B, 9, 2))
    u = rng.normal(scale=0.01, size=(B, 9, 2))
    a = 1.0 + rng.normal(scale=0.01, size=(B, 9))
    ak = 0.5 + rng.normal(scale=0.05, size=(B, 9))
    return q, u, a, ak


def _rs_samples(seed):
    """Noise-free RS flow of 9 random points under random motions."""
    rng = np.random.default_rng(seed)
    h, f, gamma = 480, 500.0, 0.9
    px = rng.uniform(0, 640, size=(B, 9, 2))
    q = (px - np.array([320.0, 240.0])) / f
    v = rng.normal(scale=0.05, size=(B, 1, 3))
    w = rng.normal(scale=0.005, size=(B, 1, 3))
    rho = 1.0 / rng.uniform(3.0, 9.0, size=(B, 9))
    u = np.zeros_like(q)
    for _ in range(6):  # α depends on the pixel flow it scales
        a = np.asarray(get_alpha(u[..., 1] * f, h, gamma))
        ak = np.asarray(get_alpha_k(px[..., 1], u[..., 1] * f, h, gamma))
        u = np.asarray(predict_flow(jnp.asarray(q), jnp.asarray(rho),
                                    jnp.asarray(v), jnp.asarray(w), 0.0,
                                    jnp.asarray(a), jnp.asarray(ak)))
    return q, u, a, ak


@pytest.mark.parametrize("make,seed", [(_random_samples, 0),
                                       (_random_samples, 1),
                                       (_rs_samples, 2)])
def test_calculate_velocities_matches_jax(make, seed):
    q, u, a, ak = make(seed)
    wj, vj, kj = _jax_velocities(
        *[jnp.asarray(x, jnp.float64) for x in (q, u, a, ak)], False)
    wt, vt, kt = tmin.calculate_velocities(
        *[torch.tensor(x, dtype=torch.float64) for x in (q, u, a, ak)], False)
    wj, vj = np.asarray(wj), np.asarray(vj)
    wt, vt = wt.numpy(), vt.numpy()
    sign = np.where(np.sum(vj * vt, axis=-1, keepdims=True) < 0, -1.0, 1.0)
    assert np.max(np.abs(wt - wj)) <= W_TOL
    assert np.max(np.abs(vt * sign - vj)) <= V_TOL
    assert (kt.numpy() == 0).all() and (np.asarray(kj) == 0).all()


def test_calculate_velocities_rejects_k_path():
    q, u, a, ak = (torch.tensor(x) for x in _random_samples(3))
    with pytest.raises(NotImplementedError):
        tmin.calculate_velocities(q, u, a, ak, True)


@pytest.mark.parametrize("n", [3, 9])
def test_eigh_small_matches_jax(n):
    rng = np.random.default_rng(n)
    m = rng.normal(size=(B, n, n))
    m = m + np.swapaxes(m, -1, -2)
    lj, vj = _jax_eigh(jnp.asarray(m))
    lt, vt = tlinalg.eigh_small(torch.tensor(m))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=1e-12)
    sign = np.sign(np.sum(vt.numpy() * np.asarray(vj), axis=-2, keepdims=True))
    np.testing.assert_allclose(vt.numpy() * sign, np.asarray(vj), rtol=0,
                               atol=1e-10)


def test_null_vector_matches_jax():
    q, u, a, _ = _rs_samples(5)
    z = jmin._beta_scale_z(jmin.build_z_columns(jnp.asarray(q), jnp.asarray(u)),
                           jnp.asarray(a))
    ej = np.asarray(_jax_null(z))
    et = tlinalg.null_vector(torch.tensor(np.asarray(z))).numpy()
    sign = np.sign(np.sum(ej * et, axis=-1, keepdims=True))
    np.testing.assert_allclose(et * sign, ej, rtol=0, atol=1e-10)
    # A true null vector: Z e ≈ 0 on noise-free samples.
    assert np.max(np.abs(np.einsum("bij,bj->bi", np.asarray(z), et))) < 1e-10


def test_build_z_columns_bit_exact():
    q, u, _, _ = _random_samples(4)
    zj = np.asarray(jmin.build_z_columns(jnp.asarray(q), jnp.asarray(u)))
    zt = tmin.build_z_columns(torch.tensor(q), torch.tensor(u)).numpy()
    np.testing.assert_array_equal(zt, zj)
