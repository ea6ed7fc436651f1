"""Geometry, RS factors, flow model and closed-form depth: rs_sfm_tpu_torch
vs the JAX package in float64 (1e-12 absolute)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rs_sfm_tpu.geom import camera as jcam
from rs_sfm_tpu.geom import rspose as jrs
from rs_sfm_tpu.geom import so3 as jso3
from rs_sfm_tpu.solver import beta as jbeta
from rs_sfm_tpu.solver import depth as jdepth
from rs_sfm_tpu.solver import flow_model as jfm
from rs_sfm_tpu_torch.geom import camera as tcam
from rs_sfm_tpu_torch.geom import rspose as trs
from rs_sfm_tpu_torch.geom import so3 as tso3
from rs_sfm_tpu_torch.solver import beta as tbeta
from rs_sfm_tpu_torch.solver import depth as tdepth
from rs_sfm_tpu_torch.solver import flow_model as tfm

# The test workers share the CPU with the JAX tests: a few intra-op threads
# each (the results do not depend on the count).
torch.set_num_threads(2)

ATOL = 1e-12
N = 257
H = 48

JI = jcam.Intrinsics(fx=70.0, fy=68.5, cx=40.2, cy=29.7)
TI = tcam.Intrinsics(fx=70.0, fy=68.5, cx=40.2, cy=29.7)


def _inputs():
    rng = np.random.default_rng(1234)
    return {
        "pix": rng.uniform(0, 80, size=(N, 2)),
        "coords": rng.normal(scale=0.4, size=(N, 2)),
        "flow": rng.normal(scale=0.02, size=(N, 2)),
        "flow_px": rng.normal(scale=3.0, size=(N, 2)),
        "pts": rng.normal(size=(N, 3)) + np.array([0.0, 0.0, 5.0]),
        "z": rng.uniform(2.0, 9.0, size=N),
        "rho": 1.0 / rng.uniform(2.0, 9.0, size=N),
        "y_px": rng.uniform(0, H, size=N),
        "alpha": 1.0 + rng.normal(scale=0.01, size=N),
        "alpha_k": 0.5 + rng.normal(scale=0.05, size=N),
        "v": np.array([0.12, -0.05, 0.08]),
        "w": np.array([0.003, -0.002, 0.004]),
        "ws": rng.normal(scale=0.01, size=(N, 3)),
        "angles": rng.uniform(-np.pi, np.pi, size=N),
        "scale": rng.uniform(-1.0, 1.0, size=N),
        "r": rng.normal(size=(N, 3, 3)),
        "t": rng.normal(size=(N, 3)),
    }


# (name, jax call, port call, input keys); scalars ride in the lambdas.
CASES = [
    ("normalize_coords", lambda m, p: m.normalize_coords(p, JI if m is jcam else TI), None, ["pix"]),
    ("normalize_flow", lambda m, f: m.normalize_flow(f, JI if m is jcam else TI), None, ["flow_px"]),
    ("normalize_flow_gamma", lambda m, f: m.normalize_flow(f, JI if m is jcam else TI, gamma=0.9), None, ["flow_px"]),
    ("plane_to_space", lambda m, p, z: m.plane_to_space(p, z, JI if m is jcam else TI), None, ["pix", "z"]),
    ("space_to_plane", lambda m, x: m.space_to_plane(x, JI if m is jcam else TI), None, ["pts"]),
    ("space_to_plane_fx_quirk", lambda m, x: m.space_to_plane(x, JI if m is jcam else TI, use_fy=False), None, ["pts"]),
    ("hat", lambda m, w: m.hat(w), "so3", ["ws"]),
    ("vee", lambda m, r: m.vee(r), "so3", ["r"]),
    ("exp_first_order", lambda m, w, s: m.exp_first_order(w, scale=s), "so3", ["ws", "scale"]),
    ("rot_y", lambda m, a: m.rot_y(a), "so3", ["angles"]),
    ("beta1", lambda m, y: m.beta1(y, H, 0.9, 0.3), "rs", ["y_px"]),
    ("world_to_camera", lambda m, x, r, t: m.world_to_camera(x, r, t), "rs", ["pts", "r", "t"]),
    ("camera_to_world", lambda m, x, r, t: m.camera_to_world(x, r, t), "rs", ["pts", "r", "t"]),
    ("get_alpha", lambda m, f: m.get_alpha(f[:, 1], H, 0.9), "beta", ["flow_px"]),
    ("get_alpha_k", lambda m, y, f: m.get_alpha_k(y, f[:, 1], H, 0.9), "beta", ["y_px", "flow_px"]),
    ("beta_factor", lambda m, a, ak: m.beta_factor(a, ak, 0.4), "beta", ["alpha", "alpha_k"]),
    ("beta_factor_dk", lambda m, a, ak: m.beta_factor_dk(a, ak, 0.4), "beta", ["alpha", "alpha_k"]),
    ("flow_basis", lambda m, c: m.flow_basis(c), "fm", ["coords"]),
    ("translational_flow", lambda m, c, v: m.translational_flow(c, v), "fm", ["coords", "v"]),
    ("rotational_flow", lambda m, c, w: m.rotational_flow(c, w), "fm", ["coords", "w"]),
    ("predict_flow", lambda m, c, r, v, w, a, ak: m.predict_flow(c, r, v, w, 0.2, a, ak), "fm",
     ["coords", "rho", "v", "w", "alpha", "alpha_k"]),
    ("flow_residual", lambda m, c, f, r, v, w, a, ak: m.flow_residual(c, f, r, v, w, 0.2, a, ak), "fm",
     ["coords", "flow", "rho", "v", "w", "alpha", "alpha_k"]),
    ("estimate_inverse_depth", lambda m, c, f, v, w, a, ak: m.estimate_inverse_depth(c, f, v, w, 0.2, a, ak),
     "depth", ["coords", "flow", "v", "w", "alpha", "alpha_k"]),
]

MODULES = {None: (jcam, tcam), "so3": (jso3, tso3), "rs": (jrs, trs),
           "beta": (jbeta, tbeta), "fm": (jfm, tfm),
           "depth": (jdepth, tdepth)}


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [np.asarray(o) for o in out]
    return [np.asarray(out)]


@pytest.mark.parametrize("name,fn,mod,keys", CASES, ids=[c[0] for c in CASES])
def test_matches_jax_f64(name, fn, mod, keys):
    data = _inputs()
    jmod, tmod = MODULES[mod]
    ref = fn(jmod, *[jnp.asarray(data[k], jnp.float64) for k in keys])
    got = fn(tmod, *[torch.tensor(data[k], dtype=torch.float64) for k in keys])
    for r, g in zip(_flat(ref), [o.numpy() for o in
                                 (got if isinstance(got, tuple) else (got,))]):
        assert g.shape == r.shape
        assert g.dtype == np.float64
        np.testing.assert_allclose(g, r, rtol=0, atol=ATOL)


def test_pixel_grid_matches():
    ref = np.asarray(jcam.pixel_grid(7, 11, dtype=jnp.float64))
    got = tcam.pixel_grid(7, 11, dtype=torch.float64).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("k", [0.0, 0.7])
def test_scanline_poses_match(k):
    v = np.array([0.12, -0.05, 0.08])
    w = np.array([0.003, -0.002, 0.004])
    rj, tj = jrs.scanline_poses(jnp.asarray(v), jnp.asarray(w),
                                jnp.float64(k), H, 0.9)
    rt, tt = trs.scanline_poses(torch.tensor(v), torch.tensor(w),
                                torch.tensor(k, dtype=torch.float64), H, 0.9)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0, atol=ATOL)


def test_informative_mask_matches():
    data = _inputs()
    v = np.array([0.0, 0.0, 0.0])
    args = [data["coords"], data["flow"], v, data["w"]]
    _, inf_j = jdepth.estimate_inverse_depth_info(
        *[jnp.asarray(a) for a in args], 0.0, jnp.asarray(data["alpha"]),
        jnp.asarray(data["alpha_k"]))
    rho_t, inf_t = tdepth.estimate_inverse_depth_info(
        *[torch.tensor(a) for a in args], 0.0, torch.tensor(data["alpha"]),
        torch.tensor(data["alpha_k"]))
    np.testing.assert_array_equal(inf_t.numpy(), np.asarray(inf_j))
    assert not inf_t.any() and (rho_t == 0).all()
