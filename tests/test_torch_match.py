"""The discrete flow search (ops/kernels/match.py) on the CPU.

  * `match_search_plain` against the search as the flow solver ran it
    before the search had a kernel (copied below from that version of
    flow/dense.py): bit-exact at the searched pyramid shapes, in both modes,
    with exact cost ties (a periodic plane) and flows that push samples
    past every edge.
  * The tile decomposition of csrc/match.cu, emulated: d2 on a tile plus a
    2-pixel halo read at clamped coordinates, row 5-sums, column 5-sums,
    gives every pixel's cost bit for bit.
  * `_coarse_init` and `_discrete_refine` against the JAX package's
    (exact refine, XLA warp) at 34x60: the ambiguity masks equal, the
    median-cleaned and second-best flows equal except where JAX's costs of
    the two candidates lie within 4 ulp (XLA contracts the warp's blend
    into fused multiply-adds, the port rounds each operation); the shifted
    refine (one warp, then integer shifts of the warped plane) bit-exact:
    the costs, picks, flows and ambiguity mask; the same
    with a prior (the relock pass's tie-break), the selection costs taking
    the raw costs' place, and the ratio fallback skipped;
  * a prior at one of several exactly tied locks takes it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax_reference import run_jitted

from rs_sfm_tpu.flow import dense as jdense
from rs_sfm_tpu_torch.flow import dense as tdense
from rs_sfm_tpu_torch.ops import stencil
from rs_sfm_tpu_torch.ops.kernels import match as tmatch
from rs_sfm_tpu_torch.ops.kernels import warp as twarp
from rs_sfm_tpu_torch.ops.kernels.warp import warp_plain

# The test workers share the CPU with the JAX tests: a few intra-op threads
# each (the results do not depend on the count).
torch.set_num_threads(2)

# The searched shapes of the full-HD e2e pass (radius 8: the coarse
# search; radius 4: the refine).
SHAPES = [(17, 30), (34, 60), (68, 120)]


# --- The search before it had a kernel (flow/dense.py, verbatim) ---------

_shift = stencil.shift
_AMB_RATIO = 0.9
_CHUNK_ELEMENTS = 1 << 24


def _box5(x):
    for axis in (-2, -1):
        x = (_shift(x, -2, axis) + _shift(x, -1, axis) + x
             + _shift(x, 1, axis) + _shift(x, 2, axis))
    return x


def _candidates(radius: int):
    side = 2 * radius + 1
    return [(float(k % side - radius), float(k // side - radius))
            for k in range(side * side)]


def _match_scan(cost_chunks, cand_of, shape, dtype, device, *,
                ratio=0.0, fallback=None):
    inf = torch.full(shape, torch.inf, dtype=dtype, device=device)
    zero = torch.zeros(shape, dtype=dtype, device=device)
    best_cost, second_cost = inf, inf
    best_u = best_v = second_u = second_v = zero
    k = 0
    for costs in cost_chunks:
        for cost in costs:
            cu, cv = cand_of(k)
            k += 1
            better = cost < best_cost
            far = torch.maximum(torch.abs(cu - best_u),
                                torch.abs(cv - best_v)) > 1.5
            to_second = better & far
            new_second = ~better & far & (cost < second_cost)
            second_cost = torch.where(
                better, torch.where(far, best_cost, second_cost),
                torch.where(new_second, cost, second_cost))
            second_u = torch.where(to_second, best_u,
                                   torch.where(new_second, cu, second_u))
            second_v = torch.where(to_second, best_v,
                                   torch.where(new_second, cv, second_v))
            best_cost = torch.where(better, cost, best_cost)
            best_u = torch.where(better, cu, best_u)
            best_v = torch.where(better, cv, best_v)
    best = torch.stack([best_u, best_v], dim=-1)
    second = torch.stack([second_u, second_v], dim=-1)
    amb = best_cost >= _AMB_RATIO * second_cost
    if ratio > 0.0 and fallback is not None:
        ok = best_cost < ratio * second_cost
        best = torch.where(ok[..., None], best, fallback)
    return best, second, amb


def _chunks(n: int, h: int, w: int):
    step = max(1, _CHUNK_ELEMENTS // (h * w))
    return [(a, min(n, a + step)) for a in range(0, n, step)]


def _old_coarse(i1m, i2m, radius, ratio):
    h, w = i1m.shape
    padded = stencil.pad_edge(i2m, radius)
    offs = _candidates(radius)

    def cost_chunks():
        for a, b in _chunks(len(offs), h, w):
            shifted = torch.stack([
                padded[int(dv) + radius:int(dv) + radius + h,
                       int(du) + radius:int(du) + radius + w]
                for du, dv in offs[a:b]])
            d = shifted - i1m
            yield _box5(d * d)

    return _match_scan(
        cost_chunks(), lambda k: offs[k], (h, w), i1m.dtype, i1m.device,
        ratio=ratio,
        fallback=torch.zeros((h, w, 2), dtype=i1m.dtype, device=i1m.device))


def _old_refine(i1m, i2m, flow, radius, ratio):
    h, w = i1m.shape
    offs = _candidates(radius)
    off_t = torch.tensor(offs, dtype=flow.dtype, device=flow.device)
    fu, fv = flow[..., 0], flow[..., 1]

    def cost_chunks():
        for a, b in _chunks(len(offs), h, w):
            cand = flow[None] + off_t[a:b, None, None, :]
            d = warp_plain(i2m, cand) - i1m
            yield _box5(d * d)

    def cand_of(k):
        du, dv = offs[k]
        return fu + du, fv + dv

    return _match_scan(cost_chunks(), cand_of, (h, w), i1m.dtype, i1m.device,
                       ratio=ratio, fallback=flow)


# --- Inputs ----------------------------------------------------------------

def _planes(h, w, seed, periodic=False):
    """Two mean-free textured planes (frame 2 about frame 1 shifted by
    (1, -2) px plus noise); `periodic` makes frame 2 a stripe pattern of
    period 3 columns in its left half, where candidates 3 px apart tie
    exactly."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(h + 8, w + 8)).astype(np.float32)
    i1 = base[4:4 + h, 4:4 + w]
    i2 = base[3:3 + h, 6:6 + w] + rng.normal(
        scale=0.05, size=(h, w)).astype(np.float32)
    if periodic:
        i2[:, : w // 2] = np.float32([0.5, -0.25, 0.75])[
            np.arange(w // 2) % 3]
    return torch.from_numpy(i1.copy()), torch.from_numpy(i2.copy())


def _flow(h, w, seed):
    """A flow near the planes' shift, with sub-pixel noise, integer values
    in one band (exact ties on integer samples), and flows of up to 1.5x
    the plane's size near the borders, which push samples past every
    edge."""
    rng = np.random.default_rng(seed)
    f = np.empty((h, w, 2), np.float32)
    f[..., 0] = 2.0 + rng.uniform(-0.6, 0.6, (h, w))
    f[..., 1] = -1.0 + rng.uniform(-0.6, 0.6, (h, w))
    f[h // 3: h // 3 + 2] = np.rint(f[h // 3: h // 3 + 2])
    f[:2, :, 1] = -1.5 * h
    f[-2:, :, 1] = 1.5 * h
    f[:, :2, 0] = -1.5 * w
    f[:, -2:, 0] = 1.5 * w
    return torch.from_numpy(f)


def _bits(t):
    return t.contiguous().numpy().view(np.uint8 if t.dtype == torch.bool
                                       else np.uint32)


# --- Tests -----------------------------------------------------------------

@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("mode", ["coarse", "refine"])
@pytest.mark.parametrize("ratio", [0.0, 0.8])
def test_plain_is_bit_exact_to_the_old_search(h, w, mode, ratio):
    i1m, i2m = _planes(h, w, seed=h, periodic=True)
    if mode == "coarse":
        radius = 8
        ref = _old_coarse(i1m, i2m, radius, ratio)
        args = (i1m, i2m, None, radius, ratio,
                torch.zeros((h, w, 2)) if ratio > 0 else None)
    else:
        radius = 4
        flow = _flow(h, w, seed=w)
        ref = _old_refine(i1m, i2m, flow, radius, ratio)
        args = (i1m, i2m, flow, radius, ratio, flow)
    got = tmatch.match_search_plain(*args)
    assert got[0].shape == (h, w, 2) and got[2].dtype == torch.bool
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(_bits(g), _bits(r))
    # The inputs reach the cases the kernel must get right: ambiguous
    # pixels (ties 3 px apart) and unambiguous ones.
    assert 0 < int(got[2].sum()) < h * w
    # On the CPU the wrapper is the plain version.
    for g, r in zip(tmatch.match_search(*args), got):
        assert torch.equal(g, r)


def _d2(i1m, i2m, flow, radius):
    """(K, H, W) squared differences of every candidate, as the plain
    version forms them."""
    h, w = i1m.shape
    offs = tmatch.candidates(radius)
    if flow is None:
        padded = stencil.pad_edge(i2m, radius)
        shifted = torch.stack([padded[int(dv) + radius:int(dv) + radius + h,
                                      int(du) + radius:int(du) + radius + w]
                               for du, dv in offs])
    else:
        shifted = warp_plain(i2m, flow[None] + torch.tensor(offs)[:, None,
                                                                 None, :])
    d = shifted - i1m
    return d * d


def _emulated_costs(d2, tile):
    """The costs as csrc/match.cu forms them from d2, tile by tile: each
    halo cell read at clamped image coordinates, then its row 5-sums, then
    the column 5-sums of the tile's cells."""
    _, h, w = d2.shape
    th, tw = tmatch.TILES[tile]
    out = torch.empty_like(d2)
    for y0 in range(0, h, th):
        for x0 in range(0, w, tw):
            ys = torch.arange(y0 - 2, y0 + th + 2).clamp(0, h - 1)
            xs = torch.arange(x0 - 2, x0 + tw + 2).clamp(0, w - 1)
            halo = d2[:, ys][:, :, xs]  # (K, th + 4, tw + 4)
            rows = (halo[:, 4:] + halo[:, 3:-1] + halo[:, 2:-2]
                    + halo[:, 1:-3] + halo[:, :-4])
            cost = (rows[..., 4:] + rows[..., 3:-1] + rows[..., 2:-2]
                    + rows[..., 1:-3] + rows[..., :-4])
            y1, x1 = min(h, y0 + th), min(w, x0 + tw)
            out[:, y0:y1, x0:x1] = cost[:, :y1 - y0, :x1 - x0]
    return out


@pytest.mark.parametrize("h,w", [(17, 30), (34, 60), (135, 240)])
@pytest.mark.parametrize("tile", range(len(tmatch.TILES)))
def test_kernel_tiles_give_the_plain_costs(h, w, tile):
    """Every tile of csrc/match.cu, on shapes its tiles cut raggedly."""
    i1m, i2m = _planes(h, w, seed=3)
    for flow, radius in ((None, 2), (_flow(h, w, seed=5), 1)):
        d2 = _d2(i1m, i2m, flow, radius)
        np.testing.assert_array_equal(_bits(_emulated_costs(d2, tile)),
                                      _bits(tmatch.box5(d2)))


def test_tile_plan_and_shared_memory():
    """The plan's tile gives the SMs 1.5 blocks each where one can (8x16 at
    135x240, 4x8 below); every e2e search fits the card's shared
    memory."""
    assert tmatch.tile_plan(135, 240, 4) == 1
    assert tmatch.tile_plan(68, 120, 4) == 3
    for h, w in ((17, 30), (34, 60), (68, 120)):
        for r in (4, 8):
            assert tmatch.smem_bytes(tmatch.tile_plan(h, w, r), r) <= 232448
    with pytest.raises(ValueError):
        tmatch.tile_plan(135, 240, 200)


def _ulps(a, b):
    """|a - b| in float32 ulps (both finite and of one sign)."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


def _cand_index(cand, base, radius):
    """Candidate index k of flows `cand` (H, W, 2) searched around `base`."""
    d = np.rint(cand - base).astype(np.int64) + radius
    return d[..., 1] * (2 * radius + 1) + d[..., 0]


def _near_3x3(mask):
    m = np.pad(mask, 1, mode="edge")
    h, w = mask.shape
    return np.any([m[dy:dy + h, dx:dx + w] for dy in range(3)
                   for dx in range(3)], axis=0)


@pytest.mark.parametrize("mode", ["coarse", "refine", "shifted"])
def test_search_matches_jax(mode):
    h, w = 34, 60
    rng = np.random.default_rng(8)
    base = rng.uniform(0.1, 0.9, (h + 12, w + 12)).astype(np.float32)
    for ax in (0, 1):
        base = ((np.roll(base, 1, ax) + 2 * base + np.roll(base, -1, ax))
                / 4).astype(np.float32)
    i1 = base[6:6 + h, 6:6 + w].copy()
    i2 = base[5:5 + h, 8:8 + w].copy()
    shifted = mode == "shifted"
    cfg_t = tdense.DenseFlowConfig(refine_shifted=shifted)
    cfg_j = jdense.DenseFlowConfig(refine_shifted=shifted,
                                   warp_engine="xla", sor_engine="xla")
    i1m, i2m = (np.array(a) for a in jdense._match_planes(
        jnp.asarray(i1), jnp.asarray(i2), cfg_j))
    if mode == "coarse":
        radius, flow = 8, None
        rj = jdense._coarse_init(jnp.asarray(i1), jnp.asarray(i2), radius,
                                 cfg_j)
        rt = tdense._coarse_init(torch.from_numpy(i1), torch.from_numpy(i2),
                                 radius, cfg_t)
        base_flow = np.zeros((h, w, 2), np.float32)
    else:
        radius = 4
        flow = (np.float32([2.0, -1.0]) + rng.uniform(
            -1.5, 1.5, (h, w, 2))).astype(np.float32)
        rj = jdense._discrete_refine(jnp.asarray(i1), jnp.asarray(i2),
                                     jnp.asarray(flow), radius, cfg_j)
        rt = tdense._discrete_refine(torch.from_numpy(i1),
                                     torch.from_numpy(i2),
                                     torch.from_numpy(flow), radius, cfg_t)
        base_flow = flow
    flow_j, second_j, amb_j = (np.asarray(a) for a in rj)
    flow_t, second_t, amb_t = (a.numpy() for a in rt)
    np.testing.assert_array_equal(amb_t, amb_j)

    # JAX's cost of every candidate, as its scan forms it (the shifted
    # refine reads the plane warped once by the flow, op by op as JAX's
    # _discrete_refine warps it).
    offs = jnp.asarray(tmatch.candidates(radius), jnp.float32)
    plane = (np.array(jdense._warp(jnp.asarray(i2m), jnp.asarray(flow)))
             if shifted else i2m)

    def cost(d):
        if flow is None or shifted:
            padded = jnp.pad(jnp.asarray(plane), radius, mode="edge")
            moved = jax.lax.dynamic_slice(
                padded, (d[1].astype(int) + radius, d[0].astype(int) + radius),
                (h, w))
        else:
            moved = jdense._warp(jnp.asarray(i2m), jnp.asarray(flow) + d)
        return jdense._box5((moved - jnp.asarray(i1m)) ** 2)

    # The shifted costs op by op (vmapped, not jitted: under jit XLA's CPU
    # fusion rounds 6.6 % of them 1 ulp away from the IEEE order).
    costs = np.asarray(jax.vmap(cost)(offs) if shifted
                       else run_jitted(jax.vmap(cost), offs))
    raw_t = tmatch.match_search_plain(
        torch.from_numpy(i1m), torch.from_numpy(plane),
        None if flow is None else torch.from_numpy(flow), radius,
        shifted=shifted)
    if shifted:
        # The port's warped plane and every candidate's cost are JAX's.
        np.testing.assert_array_equal(
            twarp.warp(torch.from_numpy(i2m), torch.from_numpy(flow))
            .numpy(), plane)
        np.testing.assert_array_equal(
            tmatch.box5((_d2(torch.from_numpy(i1m), torch.from_numpy(plane),
                             None, radius))).numpy(), costs)
    k_t = _cand_index(raw_t[0].numpy(), base_flow, radius)
    k_j = np.argmin(costs, axis=0)  # the scan keeps the first minimum
    yy, xx = np.indices((h, w))
    flipped = k_t != k_j
    near = _ulps(costs[k_t, yy, xx], costs[k_j, yy, xx]) <= 4
    assert np.all(near[flipped])
    # The median-cleaned flow differs only next to a flipped pick.
    differs = np.any(flow_t != flow_j, axis=-1)
    assert not np.any(differs & ~_near_3x3(flipped))
    # The second best: where the seconds differ, JAX's costs of the two
    # tie within 4 ulp, or the best flipped.
    s_diff = np.any(second_t != second_j, axis=-1)
    s_t = _cand_index(second_t, base_flow, radius)
    s_j = _cand_index(second_j, base_flow, radius)
    ok = np.zeros((h, w), bool)
    valid = ((s_t >= 0) & (s_t < len(offs)) & (s_j >= 0)
             & (s_j < len(offs)))
    ok[valid] = _ulps(costs[s_t[valid], yy[valid], xx[valid]],
                      costs[s_j[valid], yy[valid], xx[valid]])[...] <= 4
    assert not np.any(s_diff & ~(ok | flipped))
    # The near ties are rare: at most 2 % of the pixels.
    assert flipped.mean() <= 0.02 and s_diff.mean() <= 0.02, (
        flipped.mean(), s_diff.mean())
    if shifted:
        # Exact costs: every pick, flow and second best is JAX's.
        assert not flipped.any()
        np.testing.assert_array_equal(flow_t, flow_j)
        np.testing.assert_array_equal(second_t, second_j)
    assert 0 < amb_t.sum() < h * w or mode != "coarse"


def _smooth_prior(h, w, centre, spread, seed):
    """An (h, w, 2) float32 flow: `centre` plus a smooth random field of
    about +-spread px."""
    rng = np.random.default_rng(seed)
    f = rng.uniform(-spread, spread, (h + 8, w + 8, 2))
    for ax in (0, 1):
        for _ in range(3):
            f = (np.roll(f, 1, ax) + 2 * f + np.roll(f, -1, ax)) / 4
    f = f[4:4 + h, 4:4 + w] * 2.0
    return (np.asarray(centre, np.float32) + f).astype(np.float32)


def _selection(costs, base_flow, prior, radius):
    """JAX's selection costs (dense.py::_match_scan with a prior) of every
    candidate, formed in float32 from its raw costs in the operation order
    of dense.py::_prior_factor."""
    offs = np.asarray(tmatch.candidates(radius), np.float32)
    cand = base_flow[None] + offs[:, None, None, :]
    diff = (cand - prior[None]).astype(np.float32)
    d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
    s2 = np.float32(max(radius, 1) ** 2)
    factor = np.float32(1.0) + (np.float32(0.35) * d2) / (d2 + s2)
    return (costs * factor).astype(np.float32)


@pytest.mark.parametrize("mode", ["coarse", "refine"])
def test_prior_search_matches_jax(mode):
    """`_coarse_init` and `_discrete_refine` with a prior against the JAX
    package's at 34x60 (exact refine, XLA warp): the ambiguity masks equal
    (raw costs), the picks equal except where JAX's selection costs of the
    two candidates lie within 4 ulp (as without a prior: XLA contracts the
    warp's blend into fused multiply-adds), the median-cleaned flows
    equal except next to such a pick, the ratio fallback skipped."""
    h, w = 34, 60
    rng = np.random.default_rng(8)
    base = rng.uniform(0.1, 0.9, (h + 12, w + 12)).astype(np.float32)
    for ax in (0, 1):
        base = ((np.roll(base, 1, ax) + 2 * base + np.roll(base, -1, ax))
                / 4).astype(np.float32)
    i1 = base[6:6 + h, 6:6 + w].copy()
    i2 = base[5:5 + h, 8:8 + w].copy()
    cfg_t = tdense.DenseFlowConfig(match_ratio=0.8)
    cfg_j = jdense.DenseFlowConfig(refine_shifted=False, warp_engine="xla",
                                   sor_engine="xla", match_ratio=0.8)
    i1m, i2m = (np.array(a) for a in jdense._match_planes(
        jnp.asarray(i1), jnp.asarray(i2), cfg_j))
    if mode == "coarse":
        radius, flow = 8, None
        base_flow = np.zeros((h, w, 2), np.float32)
        prior = _smooth_prior(h, w, (2.0, -1.0), 3.0, seed=1)
        rj = jdense._coarse_init(jnp.asarray(i1), jnp.asarray(i2), radius,
                                 cfg_j, prior=jnp.asarray(prior))
        rt = tdense._coarse_init(torch.from_numpy(i1), torch.from_numpy(i2),
                                 radius, cfg_t, torch.from_numpy(prior))
    else:
        radius = 4
        flow = (np.float32([2.0, -1.0]) + rng.uniform(
            -1.5, 1.5, (h, w, 2))).astype(np.float32)
        base_flow = flow
        prior = _smooth_prior(h, w, (2.0, -1.0), 2.0, seed=2)
        rj = jdense._discrete_refine(jnp.asarray(i1), jnp.asarray(i2),
                                     jnp.asarray(flow), radius, cfg_j,
                                     prior=jnp.asarray(prior))
        rt = tdense._discrete_refine(torch.from_numpy(i1),
                                     torch.from_numpy(i2),
                                     torch.from_numpy(flow), radius, cfg_t,
                                     torch.from_numpy(prior))
    flow_j, _, amb_j = (np.asarray(a) for a in rj)
    flow_t, _, amb_t = (a.numpy() for a in rt)
    np.testing.assert_array_equal(amb_t, amb_j)

    offs = jnp.asarray(tmatch.candidates(radius), jnp.float32)

    def cost(d):
        if flow is None:
            padded = jnp.pad(jnp.asarray(i2m), radius, mode="edge")
            shifted = jax.lax.dynamic_slice(
                padded, (d[1].astype(int) + radius, d[0].astype(int) + radius),
                (h, w))
        else:
            shifted = jdense._warp(jnp.asarray(i2m), jnp.asarray(flow) + d)
        return jdense._box5((shifted - jnp.asarray(i1m)) ** 2)

    sel = _selection(np.asarray(run_jitted(jax.vmap(cost), offs)), base_flow,
                     prior, radius)
    args = (torch.from_numpy(i1m), torch.from_numpy(i2m),
            None if flow is None else torch.from_numpy(flow), radius)
    raw_t = tmatch.match_search_plain(*args, prior=torch.from_numpy(prior))
    # With a prior the ratio fallback is skipped.
    fb = torch.zeros((h, w, 2)) if flow is None else torch.from_numpy(flow)
    for a, b in zip(tmatch.match_search_plain(
            *args, 0.8, fb, prior=torch.from_numpy(prior)), raw_t):
        assert torch.equal(a, b)
    k_t = _cand_index(raw_t[0].numpy(), base_flow, radius)
    k_j = np.argmin(sel, axis=0)
    yy, xx = np.indices((h, w))
    flipped = k_t != k_j
    assert np.all(_ulps(sel[k_t, yy, xx], sel[k_j, yy, xx])[flipped] <= 4)
    assert not np.any(np.any(flow_t != flow_j, axis=-1)
                      & ~_near_3x3(flipped))
    assert flipped.mean() <= 0.02
    # The prior changed picks: it is not the prior-free search.
    free = tmatch.match_search_plain(*args)
    assert np.any(free[0].numpy() != raw_t[0].numpy())


def test_prior_breaks_exact_ties():
    """On the periodic half of the planes candidates 3 px apart tie
    exactly; a prior at the tied lock 3 px right of the prior-free pick
    takes it (its factor is 1, every other candidate's above)."""
    h, w = 34, 60
    radius = 8
    i1m, i2m = _planes(h, w, seed=4, periodic=True)
    free = tmatch.match_search_plain(i1m, i2m, None, radius)
    prior = free[0] + torch.tensor([3.0, 0.0])
    got = tmatch.match_search_plain(i1m, i2m, None, radius, prior=prior)
    costs = tmatch.box5(_d2(i1m, i2m, None, radius))
    yy, xx = np.indices((h, w))
    k_free = _cand_index(free[0].numpy(), np.zeros((h, w, 2)), radius)
    k_prior = k_free + 3
    inside = (free[0][..., 0] + 3 <= radius).numpy()
    tie = inside.copy()
    tie[inside] = (costs.numpy()[k_prior[inside], yy[inside], xx[inside]]
                   == costs.numpy()[k_free[inside], yy[inside], xx[inside]])
    tie = torch.from_numpy(tie)
    assert int(tie.sum()) > 50
    assert torch.equal(got[0][tie], prior[tie])
    # A prior at the prior-free picks keeps them.
    same = tmatch.match_search_plain(i1m, i2m, None, radius, prior=free[0])
    assert torch.equal(same[0], free[0])
