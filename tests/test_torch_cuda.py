"""CUDA kernels B1-B8 against their plain PyTorch versions on the card.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode) and
skips elsewhere.  The file imports neither JAX nor the JAX package, so it
also runs on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(`--noconftest`: tests/conftest.py configures JAX).

Tolerances: B1 counts exactly equal (the kernel and the plain version
evaluate every pixel's squared error in the same IEEE operations, and the
kernel's test against s* is the plain sqrt(s) < tol, see csrc/score.cu),
error sums rtol 1e-5 (summation order and the kernel's approximate
root).  B2/B3 state rtol
1e-5, atol 1e-7, with each sum slot also allowed 1e-5 of its
Cauchy-Schwarz bound (tests/test_torch_refine.py explains both), compared
at unit damping.  B4 warp, B5 SOR and B6 median are bit-exact: each kernel
runs its plain version's IEEE operations in the same order (B4 and B5 built
without FMA contraction; B5's tiles with halos change no pixel's
operations, tests/test_torch_sor_tiles.py), and the median uses only min
and max.  B7 (the
split LM iteration) is held to its plain versions with B3's tolerances, and
to B3 itself bit for bit: both run the same sweep, reduction and decide
code.  B8 (the z-buffer splat) is bit-exact: integer keys and a colour
copy.  B4's discrete search (csrc/match.cu) is bit-exact on every tile: the
warp's IEEE operations without FMA contraction, the box's adds and the scan
in the plain version's order.  RANSAC takes its draws on the card.
"""

import numpy as np
import pytest
import torch

from rs_sfm_tpu_torch.ops.kernels import match as tmatch
from rs_sfm_tpu_torch.ops.kernels import median as tmedian
from rs_sfm_tpu_torch.ops.kernels import refine_kernels as trk
from rs_sfm_tpu_torch.ops.kernels import score as tscore
from rs_sfm_tpu_torch.ops.kernels import sor as tsor
from rs_sfm_tpu_torch.ops.kernels import warp as twarp
from rs_sfm_tpu_torch.ops.kernels import zbuffer as tzbuffer
from rs_sfm_tpu_torch.solver.beta import get_alpha, get_alpha_k
from rs_sfm_tpu_torch.solver.flow_model import predict_flow

TOL = 0.05
HUBER = 1e-3
# Pixel counts of the LM tests: below one 1,024-pixel chunk of the sweep
# kernel, a whole number of chunks, a ragged count, and more chunks than
# the persistent grid has blocks (checked in the test that uses it).
LM_SIZES = [700, 4096, 5003, 600_011]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _score_problem(n, t, seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    p = dict(
        coords=rng.normal(scale=0.3, size=(n, 2)).astype(f32),
        flow=rng.normal(scale=0.01, size=(n, 2)).astype(f32),
        alpha=(1.0 + rng.normal(scale=0.01, size=n)).astype(f32),
        alpha_k=(0.5 + rng.normal(scale=0.05, size=n)).astype(f32),
        valid=rng.uniform(size=n) > 0.1,
        v=rng.normal(size=(t, 3)).astype(f32),
        w=rng.normal(scale=0.01, size=(t, 3)).astype(f32),
        k=rng.uniform(-0.5, 1.5, size=t).astype(f32))
    return {k: torch.from_numpy(v) for k, v in p.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("n,t", [(2048, 16), (5000, 300)])
def test_score_kernel_matches_plain(cuda_device, n, t):
    """T = 300 crosses the kernel's 256-hypothesis shared-memory chunk;
    N = 5000 leaves a ragged last block."""
    p = _score_problem(n, t, seed=6)
    px = tscore.pack_pixels(p["coords"], p["flow"], p["alpha"], p["alpha_k"],
                            p["valid"]).to(cuda_device)
    hy = tscore.pack_hyps(p["v"], p["w"], p["k"]).to(cuda_device)
    before = tscore.score_hypotheses.launches
    num_k, err_k = tscore.score_hypotheses(px, hy, TOL)
    torch.cuda.synchronize()
    assert tscore.score_hypotheses.launches == before + 1
    num_p, err_p = tscore.score_hypotheses_plain(px, hy, TOL)
    np.testing.assert_array_equal(num_k.cpu().numpy(), num_p.cpu().numpy())
    np.testing.assert_allclose(err_k.cpu().numpy(), err_p.cpu().numpy(),
                               rtol=1e-5, atol=1e-6)


def _hit(target):
    """(ux, uy) float32 with ux*ux + uy*uy == target in float32 (each
    operation rounded, no FMA), found near (sqrt(target), 0)."""
    f32 = np.float32
    base = np.sqrt(f32(target)).view(np.uint32).astype(np.int64)
    for dx in range(-8, 9):
        ux = np.uint32(base + dx).view(f32)
        rest = f32(target) - ux * ux
        if rest < 0:
            continue
        root = np.sqrt(rest).view(np.uint32).astype(np.int64)
        for dy in range(-4, 5):
            uy = np.uint32(max(root + dy, 0)).view(f32)
            if ux * ux + uy * uy == f32(target):
                return ux, uy
    raise AssertionError(f"no (ux, uy) for {target}")


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 7, 256, 300])
def test_score_kernel_counts_at_the_threshold(cuda_device, t):
    """Counts equal to the plain version where the squared residual lies at
    s* (csrc/score.cu's test s < s*) or 1 ulp either side.  Hypothesis 0 is
    zero motion, whose residual is the flow itself: 30 valid pixels carry
    flows with ux^2 + uy^2 exactly s* - 1 ulp, s* and s* + 1 ulp.  The
    tolerance is the root of hypothesis 1's median squared residual, so its
    pixels at that median lie on the threshold too.  N = 5003 leaves a
    ragged last tile; T = 300 spans two hypothesis groups."""
    n = 5003
    p = _score_problem(n, t, seed=t)
    p["v"][0] = 0.0
    p["w"][0] = 0.0
    p["k"][0] = 0.0
    px = tscore.pack_pixels(p["coords"], p["flow"], p["alpha"], p["alpha_k"],
                            p["valid"]).to(cuda_device)
    hy = tscore.pack_hyps(p["v"], p["w"], p["k"]).to(cuda_device)
    h = min(1, t - 1)
    sq = next(tscore.squared_residuals_plain(px, hy[h:h + 1]))[0]
    tol = float(np.sqrt(np.float32(sq[px[6] > 0.5].median().item())))
    sstar = np.float32(tscore.sq_threshold(tol))
    bits = sstar.view(np.uint32)
    for i in range(30):
        target = np.uint32(bits + (i % 3) - 1).view(np.float32)
        px[2, i], px[3, i] = (float(a) for a in _hit(target))
        px[6, i] = 1.0
    s0 = next(tscore.squared_residuals_plain(px, hy[:1]))[0, :30].cpu()
    assert [int(np.float32(a).view(np.uint32)) - int(bits)
            for a in s0.numpy()] == [-1, 0, 1] * 10
    num_k, err_k = tscore.score_hypotheses(px, hy, tol)
    num_p, err_p = tscore.score_hypotheses_plain(px, hy, tol)
    np.testing.assert_array_equal(num_k.cpu().numpy(), num_p.cpu().numpy())
    np.testing.assert_allclose(err_k.cpu().numpy(), err_p.cpu().numpy(),
                               rtol=1e-5, atol=1e-6)
    assert 0 < num_k[h] < n


def _lm_problem(j, n=4096, seed=8):
    """RS flow of n random points with coherent outliers, J starts."""
    rng = np.random.default_rng(seed)
    f, h, gamma = 500.0, 600, 0.9
    pix = rng.uniform(0, 599, size=(n, 2))
    coords = ((pix - 300.0) / f).astype(np.float32)
    v = np.array([0.02, -0.01, 0.015], np.float32)
    w = np.array([0.004, -0.002, 0.008], np.float32)
    rho = (1.0 / rng.uniform(3.0, 9.0, size=n)).astype(np.float32)
    fy = rng.normal(scale=2.0, size=n)
    alpha = get_alpha(fy, h, gamma).astype(np.float32)
    alpha_k = get_alpha_k(pix[:, 1], fy, h, gamma).astype(np.float32)
    flow = predict_flow(*[torch.from_numpy(a) for a in (coords, rho, v, w)],
                        0.3, torch.from_numpy(alpha),
                        torch.from_numpy(alpha_k)).numpy()
    flow = flow + rng.normal(scale=2e-4, size=(n, 2)).astype(np.float32)
    flow[:64] += np.array([3e-3, -2e-3], np.float32)
    masks = (rng.uniform(size=(j, n)) > 0.2).astype(np.float32)
    px = np.stack([coords[:, 0], coords[:, 1], flow[:, 0], flow[:, 1], alpha,
                   alpha_k, masks[0], np.zeros(n, np.float32)])
    theta = np.concatenate([
        v[None] * np.array([1.1, 1.4, 0.7, 1.2])[:j, None] + 0.003,
        w[None] * np.array([0.9, 0.5, 1.5, 1.1])[:j, None],
        np.array([0.3, 0.1, 0.6, 0.2])[:j, None]], axis=1)
    state = np.zeros((j, 128), np.float32)
    state[:, 0:7] = theta
    state[:, 7:14] = theta
    state[:, trk.S_LAM] = 3e-6
    state[:, trk.S_COST] = np.inf
    state[:, trk.S_KKEEP] = 1.0
    state[:, trk.S_ACCEPT] = 1.0
    rho_j = (rho[None] * rng.uniform(0.8, 1.2, size=(j, 1))).astype(
        np.float32)
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32))
            for a in (state, px, masks, rho_j)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", LM_SIZES)
@pytest.mark.parametrize("j", [1, 4])
@pytest.mark.parametrize("loss_delta", [0.0, HUBER])
def test_lm_kernels_match_plain(cuda_device, j, loss_delta, n):
    st, pxd, md, rpd = [a.to(cuda_device) for a in _lm_problem(j, n)]
    if n == LM_SIZES[-1]:
        blocks = trk._lib().lm_sweep_blocks(n, j)
        assert n > 1024 * blocks, (n, blocks)
    rcd = rpd
    # Bootstrap sweep, then one full step, each from the same state and
    # solving at unit damping (an accept divides the slot by 3).
    for _ in range(2):
        st = st.clone()
        st[:, trk.S_LAM] = 3.0
        if j == 1:
            before = trk.lm_iter.launches
            got = trk.lm_iter(st[0], pxd, rpd, rcd, loss_delta=loss_delta)
            assert trk.lm_iter.launches == before + 1
            ref = trk.lm_iter_plain(st[0], pxd, rpd, rcd,
                                    loss_delta=loss_delta)
        else:
            before = trk.lm_iter_multi.launches
            got = trk.lm_iter_multi(st, pxd, md, rpd, rcd,
                                    loss_delta=loss_delta)
            assert trk.lm_iter_multi.launches == before + 1
            ref = trk.lm_iter_multi_plain(st, pxd, md, rpd, rcd,
                                          loss_delta=loss_delta)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            bad = trk.state_mismatches(g.cpu().numpy(), r.cpu().numpy())
            assert not bad, bad[:10]
        st = ref[0] if j > 1 else ref[0][None]
        rpd, rcd = ref[1], ref[2]


@pytest.mark.cuda
@pytest.mark.parametrize("n", LM_SIZES)
def test_lm_kernel_is_deterministic(cuda_device, n):
    """Every sum is added in a fixed order (no float atomics): two
    launches on the same inputs give bit-identical states."""
    st, pxd, md, rpd = [a.to(cuda_device) for a in _lm_problem(4, n)]
    a = trk.lm_iter_multi(st, pxd, md, rpd, rpd, loss_delta=HUBER)
    b = trk.lm_iter_multi(st, pxd, md, rpd, rpd, loss_delta=HUBER)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("n", LM_SIZES)
@pytest.mark.parametrize("j", [1, 4])
def test_lm_split_kernels_match_plain_and_fused(cuda_device, j, n):
    """B7: the sums kernel and the decide kernel against their plain
    versions, and sums -> decide against B3's fused launch, bit for bit,
    over a bootstrap sweep and one full step."""
    st, pxd, md, rpd = [a.to(cuda_device) for a in _lm_problem(j, n)]
    rcd = rpd
    for _ in range(2):
        st = st.clone()
        st[:, trk.S_LAM] = 3.0  # unit damping, as test_lm_kernels_match_plain
        before = (trk.lm_sums_multi.launches, trk.lm_decide.launches)
        rho_eff, rho_new, sums = trk.lm_sums_multi(st, pxd, md, rpd, rcd,
                                                   loss_delta=HUBER)
        new = trk.lm_decide(st, sums)
        assert (trk.lm_sums_multi.launches, trk.lm_decide.launches) == (
            before[0] + 1, before[1] + 1)
        ref_e, ref_n, ref_s = trk.lm_sums_multi_plain(st, pxd, md, rpd, rcd,
                                                      loss_delta=HUBER)
        ref_new = trk.lm_decide_plain(st, sums)
        fused = trk.lm_iter_multi(st, pxd, md, rpd, rcd, loss_delta=HUBER)
        torch.cuda.synchronize()
        bad = trk.sums_mismatches(sums.cpu().numpy(), ref_s.cpu().numpy())
        assert not bad, bad[:10]
        for g, r in ((rho_eff, ref_e), (rho_new, ref_n), (new, ref_new)):
            bad = trk.state_mismatches(g.cpu().numpy(), r.cpu().numpy())
            assert not bad, bad[:10]
        for g, r in zip((new, rho_eff, rho_new), fused):
            assert torch.equal(g, r)
        st, rpd, rcd = fused


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(17, 30), (135, 240)])
def test_zbuffer_kernel_matches_plain(cuda_device, h, w):
    """B8 against the plain scatter engine, with forced ties: targets on a
    coarse grid, so about 12 sources share each, on four depth levels that
    include -0.0 and +0.0; a few sources are not finite or off the image."""
    rng = np.random.default_rng(11)
    tx = (rng.integers(0, max(w // 4, 1), (h, w)) * 4.0 + 0.49).astype(
        np.float32)
    ty = (rng.integers(0, max(h // 3, 1), (h, w)) * 3.0 - 0.5).astype(
        np.float32)
    d = rng.choice(np.float32([-1.0, -0.0, 0.0, 2.0]), size=(h, w))
    d[rng.uniform(size=(h, w)) < 0.02] = np.inf
    tx[rng.uniform(size=(h, w)) < 0.02] = np.nan
    ty[rng.uniform(size=(h, w)) < 0.02] = -0.51
    colors = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    args = [torch.from_numpy(a).to(cuda_device) for a in (tx, ty, d, colors)]
    before = tzbuffer.zbuffer_splat.launches
    gs, hit = tzbuffer.zbuffer_splat(*args)
    torch.cuda.synchronize()
    assert tzbuffer.zbuffer_splat.launches == before + 1
    gs_p, hit_p = tzbuffer.zbuffer_splat_plain(*args)
    assert torch.equal(hit, hit_p)
    assert torch.equal(gs, gs_p)
    assert 0 < int(hit.sum()) < h * w


# Pyramid shapes of the main path: odd rows and columns, the smallest
# level (17 x 30), a level of the half-resolution backward pass, and two
# levels that the SOR kernel cuts into many tiles with ragged edges.
FLOW_SHAPES = [(17, 30), (37, 61), (135, 240), (270, 480), (540, 960)]


def _smooth_plane(h, w, rng):
    base = rng.uniform(0.1, 0.9, (h + 4, w + 4)).astype(np.float32)
    for ax in (0, 1):
        base = (np.roll(base, 1, ax) + 2 * base + np.roll(base, -1, ax)) / 4
    return base[2:2 + h, 2:2 + w].copy()


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(1, 1), (2, 3)] + FLOW_SHAPES
                         + [(1080, 1920)])
def test_warp_kernel_matches_plain(cuda_device, h, w):
    """Flows of up to +-w/2 px leave the image on every side (clamped
    samples); a batch of K flows over one plane, P planes over one flow,
    and one plane by one flow; bit for bit, signed zeros included."""
    rng = np.random.default_rng(h)
    img = torch.from_numpy(_smooth_plane(h, w, rng)).to(cuda_device)
    flows = torch.from_numpy(rng.uniform(-w / 2, w / 2, (5, h, w, 2)).astype(
        np.float32)).to(cuda_device)
    planes = torch.stack([img, 2.0 * img - 0.3])
    for a, f in ((img, flows), (planes, flows[0]), (img, flows[1])):
        before = twarp.warp.launches
        got = twarp.warp(a, f)
        torch.cuda.synchronize()
        assert twarp.warp.launches == before + 1
        ref = twarp.warp_plain(a, f)
        assert got.shape == ref.shape
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", FLOW_SHAPES)
def test_median_kernel_matches_plain(cuda_device, h, w):
    rng = np.random.default_rng(w)
    x = torch.from_numpy(rng.normal(size=(2, h, w)).astype(np.float32)).to(
        cuda_device)
    before = tmedian.median3_planes.launches
    got = tmedian.median3_planes(x)
    torch.cuda.synchronize()
    assert tmedian.median3_planes.launches == before + 1
    assert torch.equal(got, tmedian.median3_plain(x))


def _pyramid_shapes():
    """Every level of the e2e flow's forward (full HD) and half-resolution
    backward pyramids, and the two smallest planes."""
    from rs_sfm_tpu_torch.config import E2E_FLOW_PRESET as cfg
    from rs_sfm_tpu_torch.flow.dense import pyramid_levels

    shapes = [(1, 1), (2, 3)]
    for h, w in ((1080, 1920), (540, 960)):
        for _ in range(pyramid_levels(h, w, cfg.levels)):
            shapes.append((h, w))
            h, w = (h + 1) // 2, (w + 1) // 2
    return sorted(set(shapes))


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", _pyramid_shapes())
def test_median_kernel_layouts_bit_exact(cuda_device, h, w):
    """B6 bit for bit (signed zeros included) to median3_plain in every
    layout: (P, H, W) planes for P = 1, 2, 3; a flow's median from two
    separate planes and from the halves of an (H, W, 2) flow, into a
    contiguous (H, W, 2) flow.  The data has ties and zeros of both
    signs."""
    rng = np.random.default_rng(h * 7 + w)
    x = rng.normal(size=(3, h, w)).astype(np.float32)
    x[:, ::2, ::3] = 0.0
    x[:, 1::2, ::3] = -0.0
    x[0, :, 1::4] = 0.5
    planes = torch.from_numpy(x).to(cuda_device)

    def bits(t):
        return t.contiguous().view(torch.int32)

    for p in (1, 2, 3):
        got = tmedian.median3_planes(planes[:p])
        assert torch.equal(bits(got), bits(tmedian.median3_plain(planes[:p])))
    ref = tmedian.median3_plain(planes[:2]).permute(1, 2, 0)
    flow = planes[:2].permute(1, 2, 0).contiguous()
    u, v = planes[0].clone(), planes[1].clone()
    for a, b in ((u, v), (flow[..., 0], flow[..., 1]),
                 (planes[0], planes[1])):
        before = tmedian.median3_planes.launches
        got = tmedian.median3_flow(a, b)
        torch.cuda.synchronize()
        assert tmedian.median3_planes.launches == before + 1
        assert got.shape == (h, w, 2) and got.is_contiguous()
        assert torch.equal(bits(got), bits(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [1, 7, 20])
@pytest.mark.parametrize("h,w", FLOW_SHAPES)
def test_sor_kernel_matches_plain(cuda_device, h, w, iters):
    """Coefficient planes of a real warp (gradients of a smooth image pair)
    with a flow far from the solution, so the Charbonnier weights vary; u
    and v as planes and as the halves of an (H, W, 2) flow."""
    rng = np.random.default_rng(h + w)
    i1 = _smooth_plane(h, w, rng)
    i2 = np.roll(i1, (1, 2), (0, 1))
    gy1, gx1 = np.gradient(i1)
    gy2, gx2 = np.gradient(i2)
    gxy, gxx = np.gradient(gx2)
    gyy, _ = np.gradient(gy2)
    u0 = rng.normal(scale=0.5, size=(h, w)).astype(np.float32)
    v0 = rng.normal(scale=0.5, size=(h, w)).astype(np.float32)
    it = i2 - i1
    coef = np.stack([gx2, gy2, it - gx2 * u0 - gy2 * v0, gxx, gxy, gyy,
                     gx2 - gx1 - gxx * u0 - gxy * v0,
                     gy2 - gy1 - gxy * u0 - gyy * v0]).astype(np.float32)
    coef, u0, v0 = [torch.from_numpy(a).to(cuda_device)
                    for a in (coef, u0, v0)]
    params = dict(iters=iters, omega=1.85, lam=0.08, eps2=1e-6, wbr=1.0,
                  wgrad=0.7)
    before = tsor.sor_sweeps.launches
    u_k, v_k = tsor.sor_sweeps(coef, u0, v0, **params)
    torch.cuda.synchronize()
    launches = tsor.launches_per_call(h, w, iters,
                                      tsor.card_limits(cuda_device))
    assert tsor.sor_sweeps.launches == before + launches
    assert launches <= -(-iters // tsor.SWEEPS_PER_LAUNCH)
    u_p, v_p = tsor.sor_sweeps_plain(coef, u0, v0, **params)
    assert not torch.equal(u_p, u0)
    assert torch.equal(u_k, u_p) and torch.equal(v_k, v_p)
    # The same from the halves of an (H, W, 2) flow, read where they lie.
    flow = torch.stack([u0, v0], dim=-1)
    assert tsor.read_stride(flow[..., 0], flow[..., 1]) == 2
    u_f, v_f = tsor.sor_sweeps(coef, flow[..., 0], flow[..., 1], **params)
    assert torch.equal(u_f, u_p) and torch.equal(v_f, v_p)


# The discrete searches of the e2e pass: (shape, radius, refine).
SEARCHES = [((135, 240), 4, True), ((68, 120), 4, True), ((34, 60), 4, True),
            ((17, 30), 4, True), ((34, 60), 8, False), ((17, 30), 8, False)]


def _search_inputs(h, w, seed):
    """Matching planes (frame 2 about frame 1 moved by (2, -1) px; its left
    half a stripe pattern of period 3 columns, where candidates 3 px apart
    tie exactly) and a flow with sub-pixel noise, an integer band, and
    flows of 1.5x the plane near the borders (samples past every edge)."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(h + 8, w + 8)).astype(np.float32)
    i1 = base[4:4 + h, 4:4 + w].copy()
    i2 = base[3:3 + h, 6:6 + w].copy()
    i2[:, : w // 2] = np.float32([0.5, -0.25, 0.75])[np.arange(w // 2) % 3]
    f = np.empty((h, w, 2), np.float32)
    f[..., 0] = 2.0 + rng.uniform(-0.6, 0.6, (h, w))
    f[..., 1] = -1.0 + rng.uniform(-0.6, 0.6, (h, w))
    f[h // 3: h // 3 + 2] = np.rint(f[h // 3: h // 3 + 2])
    f[:2, :, 1] = -1.5 * h
    f[-2:, :, 1] = 1.5 * h
    f[:, :2, 0] = -1.5 * w
    f[:, -2:, 0] = 1.5 * w
    return [torch.from_numpy(a) for a in (i1, i2, f)]


def _same_bits(a, b):
    if a.dtype == torch.bool:
        return torch.equal(a, b)
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("ratio", [0.0, 0.8])
@pytest.mark.parametrize("shape,radius,refine", SEARCHES)
def test_match_kernel_matches_plain(cuda_device, shape, radius, refine,
                                    ratio):
    """Every e2e search shape in its mode, through the wrapper (one launch)
    and on every tile of csrc/match.cu."""
    h, w = shape
    i1m, i2m, flow = (a.to(cuda_device) for a in _search_inputs(h, w, h))
    fb = flow if refine else torch.zeros_like(flow)
    args = (i1m, i2m, flow if refine else None, radius, ratio,
            fb if ratio > 0 else None)
    ref = tmatch.match_search_plain(*args)
    assert 0 < int(ref[2].sum()) < h * w
    limits = tsor.card_limits(cuda_device)
    before = tmatch.match_search.launches
    got = tmatch.match_search(*args)
    torch.cuda.synchronize()
    assert tmatch.match_search.launches == before + 1
    for g, r in zip(got, ref):
        assert g.shape == r.shape and _same_bits(g, r)
    if refine:  # a flow laid out as planes, as the pyramid's upsample gives
        planar = flow.permute(2, 0, 1).contiguous().permute(1, 2, 0)
        got = tmatch.match_search(i1m, i2m, planar, *args[3:])
        assert all(_same_bits(g, r) for g, r in zip(got, ref))
    for tile in range(len(tmatch.TILES)):
        if tmatch.smem_bytes(tile, radius) > limits[1]:
            continue
        res = tmatch.match_launch(*args, tile)
        torch.cuda.synchronize()
        for g, r in zip(res, ref):
            assert _same_bits(g, r), tile


@pytest.mark.cuda
def test_ransac_takes_draws_on_the_card(cuda_device):
    """Draws made on the card by `sample_valid_indices` go to `ransac` and
    `estimate_from_flow` as they are, with the results of the same draws
    handed over from the host."""
    import dataclasses

    from rs_sfm_tpu_torch.config import ESTIMATION_CONFIG
    from rs_sfm_tpu_torch.geom.camera import Intrinsics
    from rs_sfm_tpu_torch.solver import pipeline, ransac

    cfg = dataclasses.replace(ESTIMATION_CONFIG, ransac_trials=32,
                              refine_iterations=3, refine_winnow_iters=2)
    h, w, f = 48, 64, 60.0
    intr = Intrinsics(fx=f, fy=f, cx=w / 2.0, cy=h / 2.0)
    rng = np.random.default_rng(2)
    flow = (np.float32([0.8, -0.4]) + rng.normal(scale=0.05, size=(h, w, 2))
            ).astype(np.float32)
    flow = torch.from_numpy(flow).to(cuda_device)
    coords, flow_n, alpha, alpha_k, valid = pipeline.prepare_flow_inputs(
        flow, intr, 0.9, cfg)
    draws = ransac.sample_valid_indices(
        torch.Generator(device=cuda_device).manual_seed(3), valid,
        cfg.ransac_trials)
    assert draws.is_cuda
    fits = []
    for idx in (draws, draws.cpu(), draws.cpu().numpy()):
        rr = ransac.ransac(coords, flow_n, alpha, alpha_k, valid,
                           use_k=False, trials=cfg.ransac_trials,
                           tolerance=cfg.ransac_tol, sample_indices=idx,
                           engine=cfg.ransac_engine, top_j=cfg.refine_starts)
        res = pipeline.estimate_from_flow(flow, intr, 0.9, cfg,
                                          sample_indices=idx)
        fits.append([rr.v, rr.num_inliers, res.v, res.w, res.num_inliers])
    for got in fits[1:]:
        for a, b in zip(got, fits[0]):
            assert torch.equal(a, b)
