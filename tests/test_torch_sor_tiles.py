"""The tile decomposition of the SOR kernel (csrc/sor.cu), emulated in
plain PyTorch on the CPU and held bit for bit to `sor_sweeps_plain`.

The emulation does what each launch of the kernel does: it cuts the plane
into the tiles of `tile_plan`, copies each with its halo (clipped at the
image edges), runs the launch's colour passes on the copy with the parity of
global coordinates, updating at pass p of 2s only the cells within 2s-1-p
of the tile's interior, takes a missing neighbour as the cell itself, and
writes back the interior; launches read the previous launch's planes.  The
shapes are odd levels of the flow pyramid; the tiles are the kernel's own,
and smaller ones that cut these shapes into many ragged tiles.
"""

import numpy as np
import pytest
import torch

from rs_sfm_tpu_torch.ops.kernels import sor as tsor

# The test workers share the CPU with the JAX tests: a few intra-op threads
# each (the results do not depend on the count).
torch.set_num_threads(2)

PARAMS = dict(omega=1.85, lam=0.08, eps2=1e-6, wbr=1.0, wgrad=0.7)
K = tsor.SWEEPS_PER_LAUNCH


def _emulate(coef, u, v, iters, plan):
    h, w = u.shape
    tile_h, tile_w, halo, sweeps = plan
    done = 0
    while done < iters:
        s = min(sweeps, iters - done)
        u_out, v_out = torch.empty_like(u), torch.empty_like(v)
        for ty0 in range(0, h, tile_h):
            for tx0 in range(0, w, tile_w):
                ty1, tx1 = min(h, ty0 + tile_h), min(w, tx0 + tile_w)
                gy0, gx0 = max(0, ty0 - halo), max(0, tx0 - halo)
                gy1, gx1 = min(h, ty1 + halo), min(w, tx1 + halo)
                terms = tsor.sor_terms(coef[:, gy0:gy1, gx0:gx1])
                uc, vc = u[gy0:gy1, gx0:gx1], v[gy0:gy1, gx0:gx1]
                ys = torch.arange(gy0, gy1)[:, None]
                xs = torch.arange(gx0, gx1)[None, :]
                for p in range(2 * s):
                    m = 2 * s - 1 - p
                    sel = (((ys + xs) % 2 == p % 2)
                           & (ys >= ty0 - m) & (ys < ty1 + m)
                           & (xs >= tx0 - m) & (xs < tx1 + m))
                    uc, vc = tsor.sor_colour_pass(terms, uc, vc, sel,
                                                  **PARAMS)
                inner = (slice(ty0 - gy0, ty1 - gy0),
                         slice(tx0 - gx0, tx1 - gx0))
                u_out[ty0:ty1, tx0:tx1] = uc[inner]
                v_out[ty0:ty1, tx0:tx1] = vc[inner]
        u, v = u_out, v_out
        done += s
    return u, v


def _problem(h, w):
    rng = np.random.default_rng(h * w)
    coef = rng.normal(scale=0.3, size=(8, h, w)).astype(np.float32)
    coef[2] *= 0.1
    u0 = rng.normal(scale=0.5, size=(h, w)).astype(np.float32)
    v0 = rng.normal(scale=0.5, size=(h, w)).astype(np.float32)
    return [torch.from_numpy(a) for a in (coef, u0, v0)]


@pytest.mark.parametrize("iters", [1, K - 1, 20])
@pytest.mark.parametrize("h,w", [(16, 30), (33, 60), (67, 120), (135, 240)])
def test_kernel_tiles_match_plain(h, w, iters):
    """The kernel's own plan: one launch for the whole plane at 16x30 and
    33x60, 3x3 and 6x5 ragged small tiles at 67x120 and 135x240."""
    coef, u0, v0 = _problem(h, w)
    plan = tsor.tile_plan(h, w, iters)
    launches = tsor.launches_per_call(h, w, iters)
    if h * w <= 33 * 60:
        assert plan == (h, w, 0, iters) and launches == 1
    else:
        assert plan == (*tsor.TILE_SMALL, 2 * K, K)
        assert launches == -(-iters // K)
        assert tsor.smem_bytes(h, w, *plan[:3]) <= tsor.H100_LIMITS[1]
    up, vp = tsor.sor_sweeps_plain(coef, u0, v0, iters=iters, **PARAMS)
    ue, ve = _emulate(coef, u0, v0, iters, plan)
    assert not torch.equal(up, u0)
    assert torch.equal(ue, up) and torch.equal(ve, vp)


@pytest.mark.parametrize("tile", [tsor.TILE, (7, 10), (16, 13)])
def test_other_tiles_match_plain(tile):
    """The large planes' tile (2x2 ragged tiles here), and tiles smaller
    than their halo, odd in both axes: every interior leans on halos that
    cross several neighbouring tiles."""
    coef, u0, v0 = _problem(67, 120)
    plan = (*tile, 2 * K, K)
    up, vp = tsor.sor_sweeps_plain(coef, u0, v0, iters=9, **PARAMS)
    ue, ve = _emulate(coef, u0, v0, 9, plan)
    assert torch.equal(ue, up) and torch.equal(ve, vp)


@pytest.mark.parametrize("h,w", [(1, 1), (1, 5), (6, 1), (17, 30)])
def test_read_stride_of_flow_layouts(h, w):
    """The first launch reads u and v where they lie: contiguous planes
    at column stride 1, the halves of an (H, W, 2) flow (as the flow's
    median writes it) at 2; the (W, H) transpose of a plane, or halves of
    different strides, are copied first."""
    planes = torch.zeros((2, h, w))
    flow = torch.zeros((h, w, 2))
    assert tsor.read_stride(planes[0], planes[1]) == 1
    assert tsor.read_stride(flow[..., 0], flow[..., 1]) == (1 if h * w == 1
                                                            else 2)
    if h > 1 and w > 1:
        assert tsor.read_stride(flow[..., 0], planes[1]) is None
        square = torch.zeros((w, w))
        assert tsor.read_stride(square.t(), square) is None
