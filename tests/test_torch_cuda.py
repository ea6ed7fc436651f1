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
in the plain version's order, with a prior too (the selection cost's
factor without contraction), and in its shifted mode.  The census term of
B5 is bit-exact on both of its designs (no FMA contraction, channels summed
in a fixed order).  The camera-pipeline nuisances agree with the
CPU to 1e-6 (elementwise operations; the DCT has no matmul).  RANSAC takes
its draws on the card.
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


def _splat_args(h, w, seed, device, *, spread=2.0, base=None):
    """(tx, ty, depth, colors) of a dense splat field on the card: each
    source near its own pixel (+-`spread` px, so targets collide at about
    the rate of a rectification's depth edges), depths on a coarse grid of
    values (ties) that include -0.0 and +0.0, and a few sources that are
    not finite or leave the image.  With `base` (h, w + pad), every input
    is a column slice of a wider tensor starting at column 1, so no row
    starts 16-byte aligned."""
    rng = np.random.default_rng(seed)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    tx = (xs + rng.uniform(-spread, spread, (h, w))).astype(np.float32)
    ty = (ys + rng.uniform(-spread, spread, (h, w))).astype(np.float32)
    d = rng.choice(np.float32([-0.0, 0.0, 1.5, 2.0, 2.0, 3.25]),
                   size=(h, w))
    d[rng.uniform(size=(h, w)) < 0.02] = np.nan
    tx[rng.uniform(size=(h, w)) < 0.02] = np.inf
    colors = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    arrays = [tx, ty, d, colors]
    if base is not None:
        wide = []
        for a in arrays:
            full = np.zeros((h, w + base) + a.shape[2:], np.float32)
            full[:, 1:w + 1] = a
            wide.append(torch.from_numpy(full).to(device)[:, 1:w + 1])
        return wide
    return [torch.from_numpy(a).to(device) for a in arrays]


def _check_splat(args):
    """B8 on `args` (one launch) bit-exact to zbuffer_splat_plain."""
    before = tzbuffer.zbuffer_splat.launches
    gs, hit = tzbuffer.zbuffer_splat(*args)
    torch.cuda.synchronize()
    assert tzbuffer.zbuffer_splat.launches == before + 1
    gs_p, hit_p = tzbuffer.zbuffer_splat_plain(*args)
    assert torch.equal(hit, hit_p)
    assert torch.equal(gs.view(torch.int32), gs_p.view(torch.int32))
    return hit


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(9, 1), (9, 3), (9, 5), (37, 1921)])
def test_zbuffer_widths(cuda_device, h, w):
    """Row widths below one vector of four sources, ragged by 1 and by 3,
    and a full-HD row plus one."""
    hit = _check_splat(_splat_args(h, w, w, cuda_device))
    assert 0 < int(hit.sum()) < h * w


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(5, 7), (33, 480)])
def test_zbuffer_unaligned_column_slice(cuda_device, h, w):
    """Every input a column slice starting 4 bytes into a wider row: no
    row is 16-byte aligned and rows are not contiguous with each other."""
    args = _splat_args(h, w, 3, cuda_device, base=5)
    assert not args[0].is_contiguous() and args[0].data_ptr() % 16 != 0
    hit = _check_splat(args)
    assert 0 < int(hit.sum()) < h * w


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(1, 1), (64, 96), (540, 960)])
def test_zbuffer_all_splats_on_one_target(cuda_device, h, w):
    """Every source lands on one target, with tied depths: the least depth
    and, among its sources, the lowest id win."""
    args = _splat_args(h, w, 5, cuda_device)
    args[0] = torch.full((h, w), 0.4, device=cuda_device)
    args[1] = torch.full((h, w), 0.0, device=cuda_device)
    hit = _check_splat(args)
    assert int(hit.sum()) == int(hit[0, 0])


@pytest.mark.cuda
def test_zbuffer_equal_depths_and_signed_zeros(cuda_device):
    """All depths equal, then all of them ±0.0: ties resolve by source id
    alone, and -0.0 ties with +0.0."""
    args = _splat_args(48, 64, 6, cuda_device, spread=3.0)
    args[2] = torch.full((48, 64), 2.5, device=cuda_device)
    _check_splat(args)
    rng = np.random.default_rng(6)
    args[2] = torch.from_numpy(rng.choice(np.float32([-0.0, 0.0]),
                                          size=(48, 64))).to(cuda_device)
    _check_splat(args)


@pytest.mark.cuda
def test_zbuffer_non_finite_coordinates(cuda_device):
    """NaN and ±inf in either coordinate or the depth drop the source;
    so do targets that round just outside the image (-0.5 rounds to 0,
    w - 0.5 to w)."""
    h, w = 31, 45
    args = _splat_args(h, w, 8, cuda_device)
    rng = np.random.default_rng(8)
    for i, bad in ((0, np.nan), (0, np.inf), (0, -np.inf), (1, np.nan),
                   (1, np.inf), (1, -np.inf), (2, np.inf), (2, -np.inf)):
        mask = torch.from_numpy(rng.uniform(size=(h, w)) < 0.05).to(
            cuda_device)
        args[i] = torch.where(mask, torch.tensor(bad, device=cuda_device),
                              args[i])
    args[0][0, :5] = torch.tensor([-0.5, -0.50001, w - 0.5, w - 0.50001, 0.0])
    args[1][1, :5] = torch.tensor([-0.5, -0.50001, h - 0.5, h - 0.50001, 0.0])
    hit = _check_splat(args)
    assert 0 < int(hit.sum()) < h * w


@pytest.mark.cuda
@pytest.mark.parametrize("two_streams", [False, True])
def test_zbuffer_back_to_back(cuda_device, two_streams):
    """Calls in a row with no synchronisation between, on different inputs
    and shapes: a key left behind by one call would show in the next.  The
    key buffer starts afresh and grows twice (the first call and the
    last), the last time while the other stream's call may still run."""
    cases = [_splat_args(h, w, h + w, cuda_device)
             for h, w in ((120, 200), (120, 200), (37, 61), (120, 200),
                          (150, 260))]
    torch.cuda.synchronize()
    tzbuffer._KEYS.clear()
    streams = ([torch.cuda.Stream(cuda_device) for _ in range(2)]
               if two_streams else [torch.cuda.current_stream(cuda_device)])
    before = tzbuffer.zbuffer_splat.launches
    outs = []
    for i, args in enumerate(cases):
        with torch.cuda.stream(streams[i % len(streams)]):
            outs.append(tzbuffer.zbuffer_splat(*args))
    torch.cuda.synchronize()
    assert tzbuffer.zbuffer_splat.launches == before + len(cases)
    for (gs, hit), args in zip(outs, cases):
        gs_p, hit_p = tzbuffer.zbuffer_splat_plain(*args)
        assert torch.equal(hit, hit_p) and torch.equal(gs, gs_p)


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


def _census_problem(h, w, seed, device):
    """SOR's coefficient and census planes of a real warp (a smooth plane,
    frame 2 rolled by (1, 2) px with its exposure raised by 1.2) around a
    flow far from the solution, on `device`."""
    from rs_sfm_tpu_torch.flow import dense as tdense

    rng = np.random.default_rng(seed)
    i1 = torch.from_numpy(_smooth_plane(h, w, rng)).to(device)
    i2w = 1.2 * torch.roll(i1, (1, 2), (0, 1))
    flow = torch.from_numpy(rng.normal(scale=0.5, size=(h, w, 2)).astype(
        np.float32)).to(device)
    coef = tdense.linearize(i1, i2w, flow).contiguous()
    census = tdense.census_planes(tdense._census_channels(i1, 0.04), i2w,
                                  flow, 0.04).contiguous()
    return coef, census, flow[..., 0].contiguous(), flow[..., 1].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [7, 20])
@pytest.mark.parametrize("h,w", FLOW_SHAPES)
def test_sor_kernel_with_census_matches_plain(cuda_device, h, w, iters):
    """The census term (24 more planes, read from global memory on the
    plan without census): through the wrapper (its plan and launches),
    bit-exact to the plain version; census None and a zero census weight
    keep the bits of the run without census."""
    coef, census, u0, v0 = _census_problem(h, w, h + w, cuda_device)
    params = dict(iters=iters, omega=1.85, lam=0.08, eps2=1e-6, wbr=1.0,
                  wgrad=0.7)
    limits = tsor.card_limits(cuda_device)
    before = tsor.sor_sweeps.launches
    u_k, v_k = tsor.sor_sweeps(coef, u0, v0, census=census,
                               census_weight=1.0, **params)
    torch.cuda.synchronize()
    assert tsor.sor_sweeps.launches == before + tsor.launches_per_call(
        h, w, iters, limits)
    u_p, v_p = tsor.sor_sweeps_plain(coef, u0, v0, census=census,
                                     census_weight=1.0, **params)
    assert torch.equal(u_k, u_p) and torch.equal(v_k, v_p)
    u_n, _ = tsor.sor_sweeps_plain(coef, u0, v0, **params)
    assert not torch.equal(u_n, u_p)
    u_z, _ = tsor.sor_sweeps(coef, u0, v0, census=census, census_weight=0.0,
                             **params)
    u_0, _ = tsor.sor_sweeps(coef, u0, v0, **params)
    assert torch.equal(u_0, u_n) and torch.equal(u_z, u_n)


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
@pytest.mark.parametrize("kind", ["smooth", "ties"])
@pytest.mark.parametrize("shape,radius,refine", SEARCHES)
def test_match_kernel_with_a_prior_matches_plain(cuda_device, shape, radius,
                                                 refine, kind):
    """The search with a prior (the relock pass's tie-break) at every e2e
    search shape: a smooth random prior, and a prior at the lock 3 px
    right of the prior-free pick, where the planes' periodic half ties
    candidates exactly.  Bit-exact to the plain version through the wrapper
    and on every tile, from a prior laid out as planes too; a ratio and
    fallback given beside the prior change nothing (skipped)."""
    h, w = shape
    i1m, i2m, flow = (a.to(cuda_device) for a in _search_inputs(h, w, h))
    base = flow if refine else None
    if kind == "smooth":
        rng = np.random.default_rng(w)
        prior = torch.from_numpy(rng.uniform(-1.0, 1.0, (h, w, 2)).astype(
            np.float32)).to(cuda_device)
        prior = torch.nn.functional.avg_pool2d(
            prior.permute(2, 0, 1)[None], 5, 1, 2)[0].permute(1, 2, 0)
        prior = prior * 3.0 + (flow if refine else 0.0)
    else:
        free = tmatch.match_search_plain(i1m, i2m, base, radius)
        prior = free[0] + torch.tensor([3.0, 0.0], device=cuda_device)
    args = (i1m, i2m, base, radius)
    ref = tmatch.match_search_plain(*args, prior=prior)
    assert 0 < int(ref[2].sum()) < h * w
    before = tmatch.match_search.launches
    got = tmatch.match_search(*args, prior=prior)
    torch.cuda.synchronize()
    assert tmatch.match_search.launches == before + 1
    for g, r in zip(got, ref):
        assert g.shape == r.shape and _same_bits(g, r)
    planar = prior.permute(2, 0, 1).contiguous().permute(1, 2, 0)
    fb = flow if refine else torch.zeros_like(flow)
    got = tmatch.match_search(*args, 0.8, fb, planar)
    assert all(_same_bits(g, r) for g, r in zip(got, ref))
    limits = tsor.card_limits(cuda_device)
    for tile in range(len(tmatch.TILES)):
        if tmatch.smem_bytes(tile, radius) > limits[1]:
            continue
        res = tmatch.match_launch(*args, 0.0, None, tile, prior)
        torch.cuda.synchronize()
        for g, r in zip(res, ref):
            assert _same_bits(g, r), tile
    # The prior moved picks.
    free = tmatch.match_search(*args)
    assert not torch.equal(free[0], got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("prior", [False, True])
@pytest.mark.parametrize("ratio", [0.0, 0.8])
@pytest.mark.parametrize("shape", [s for s, r, refine in SEARCHES if refine])
def test_match_kernel_shifted_matches_plain(cuda_device, shape, ratio,
                                            prior):
    """The shifted refine (frame 2's plane warped once by the flow, the
    candidates read at integer shifts of it) at the e2e refine shapes,
    radius 4, with and without a prior and the ratio fallback: bit-exact
    to the plain version through the wrapper (one launch) and on every
    tile; it is not the exact refine."""
    h, w = shape
    i1m, i2m, flow = (a.to(cuda_device) for a in _search_inputs(h, w, h))
    warped = twarp.warp(i2m, flow)
    pr = None
    if prior:
        rng = np.random.default_rng(w)
        pr = flow + torch.from_numpy(rng.uniform(-3.0, 3.0, (h, w, 2)).astype(
            np.float32)).to(cuda_device)
    args = (i1m, warped, flow, 4, ratio, flow if ratio > 0 else None, pr)
    ref = tmatch.match_search_plain(*args, shifted=True)
    assert 0 < int(ref[2].sum()) < h * w
    before = tmatch.match_search.launches
    got = tmatch.match_search(*args, shifted=True)
    torch.cuda.synchronize()
    assert tmatch.match_search.launches == before + 1
    for g, r in zip(got, ref):
        assert g.shape == r.shape and _same_bits(g, r)
    limits = tsor.card_limits(cuda_device)
    for tile in range(len(tmatch.TILES)):
        if tmatch.smem_bytes(tile, 4) > limits[1]:
            continue
        res = tmatch.match_launch(*args[:6], tile, pr, shifted=True)
        torch.cuda.synchronize()
        for g, r in zip(res, ref):
            assert _same_bits(g, r), tile
    exact = tmatch.match_search(*args)
    assert not torch.equal(exact[0], got[0])


@pytest.mark.cuda
def test_camera_pipeline_nuisances_on_the_card_match_cpu(cuda_device):
    """apply_photometric with every camera-pipeline stage (the pseudo-real
    gate's frame 2) on the card against the CPU, float32, the same noise:
    the DCT is elementwise products and sums (no matmul), so the JPEG
    coefficients round alike and the frames agree to a few ulp."""
    from rs_sfm_tpu_torch.data.synthetic import apply_photometric

    img = torch.from_numpy(np.random.default_rng(5).uniform(
        0.0, 1.0, (67, 93, 3)).astype(np.float32))
    noise = torch.from_numpy(np.random.default_rng(6).normal(
        size=(67, 93, 3)).astype(np.float32))
    opts = dict(exposure=1.25, vignette=0.25, noise_sigma=0.004,
                motion_blur_px=3.0, blur=True, demosaic=True,
                jpeg_quality=82)
    ref = apply_photometric(img, noise=noise, **opts)
    got = apply_photometric(img.to(cuda_device),
                            noise=noise.to(cuda_device), **opts)
    assert float(torch.abs(got.cpu() - ref).max()) <= 1e-6


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


@pytest.mark.cuda
def test_feedback_recovers_corrupted_band_on_the_card(cuda_device):
    """tests/test_feedback.py's corrupted-band test, at 96x128 on the card
    with its thresholds (the body is test_torch_gates.py's)."""
    from test_torch_gates import check_feedback_recovers_band

    check_feedback_recovers_band(cuda_device)


@pytest.mark.cuda
def test_estimate_with_feedback_config_pass_on_the_card(cuda_device):
    """tests/test_feedback.py's config-pass test ("refine" mode), at
    96x128 on the card with its thresholds."""
    from test_torch_gates import check_feedback_config_pass

    check_feedback_config_pass(cuda_device)


@pytest.mark.cuda
def test_estimate_with_feedback_config_pass_full_on_the_card(cuda_device):
    """The same test in feedback_mode "full" (each feedback pass the whole
    schedule again, on its own generator on the card)."""
    from test_torch_gates import check_feedback_config_pass

    check_feedback_config_pass(cuda_device, "full")


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["pallas", "xla"])
def test_sharded_acceleration_on_the_card_matches_cpu(cuda_device, engine):
    """estimate_sharded with the acceleration model and the prescore over
    a gloo group of one rank, on CUDA tensors (B1 per rank; B7 with k free
    under the fused engine) against the same on the CPU (the plain twins),
    on the 64x64 castle with k 0.8 and the same draws: v direction 1e-3,
    w 1e-5, k 1e-3, inliers within 0.5 % (float32 sums in other orders and
    B1's approximate root), and the acceleration gate."""
    import dataclasses

    from torch_parallel_ranks import solo_group

    from rs_sfm_tpu_torch.config import PipelineConfig
    from rs_sfm_tpu_torch.data.synthetic import (castle_scene,
                                                 default_intrinsics,
                                                 render_pair)
    from rs_sfm_tpu_torch.eval.gate import V_TRUE, W_TRUE
    from rs_sfm_tpu_torch.flow.true_flow import true_flow
    from rs_sfm_tpu_torch.parallel.api import estimate_sharded
    from rs_sfm_tpu_torch.solver.ransac import sample_valid_indices

    size = 64
    intr = default_intrinsics(size, size)
    pair = render_pair(castle_scene(torch.float64, "cpu"), intr, size, size,
                       gamma=0.9, k=0.8, v=V_TRUE, w=W_TRUE,
                       dtype=torch.float64)
    flow = true_flow(pair.frame1.rs_unproject, pair.frame2.poses_r,
                     pair.frame2.poses_t, intr).to(torch.float32)
    cfg = PipelineConfig(ransac_trials=64, ransac_tol=0.02,
                         refine_iterations=20, refine_starts=2,
                         refine_rel_tol=0.0, use_acceleration=True,
                         k_scan_points=9, ransac_prescore_subsample=256,
                         ransac_prescore_keep=8)
    if engine == "pallas":
        cfg = dataclasses.replace(cfg, refine_engine="pallas",
                                  ransac_engine="pallas")
    # A pool of every pixel: the draws index the image.
    valid = torch.linalg.vector_norm(flow, dim=-1).reshape(-1) > 0
    draws = sample_valid_indices(torch.Generator().manual_seed(3), valid,
                                 cfg.ransac_trials)
    rk = trk.lm_sums_multi
    with solo_group() as group:
        run = estimate_sharded(group, intr, 0.9, cfg,
                               pool_per_shard=size * size)
        want = run(flow, sample_indices=draws)
        before = (tscore.score_hypotheses.launches, rk.launches)
        got = run(flow.to(cuda_device), sample_indices=draws.to(cuda_device))
        torch.cuda.synchronize()
        after = (tscore.score_hypotheses.launches, rk.launches)
    assert after[0] - before[0] == 2  # the prescore, then the shortlist
    assert (after[1] > before[1]) == (engine == "pallas")
    unit = lambda v: v / np.linalg.norm(v)  # noqa: E731
    gv, wv = got.v.cpu().double().numpy(), want.v.double().numpy()
    np.testing.assert_allclose(unit(gv), unit(wv), rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.w.cpu().numpy(), want.w.numpy(), rtol=0,
                               atol=1e-5)
    assert abs(float(got.k) - float(want.k)) < 1e-3
    assert abs(int(got.num_inliers) - int(want.num_inliers)) <= 0.005 * (
        size * size)
    assert abs(float(got.k) - 0.8) < 0.2
    cos = float(unit(gv) @ unit(np.asarray(V_TRUE)))
    assert np.arccos(min(1.0, cos)) < 0.05


@pytest.mark.cuda
def test_auto_probe_on_the_card_matches_cpu(cuda_device):
    """The auto preset's probe (B4-B6 in its flow) on the card against its
    CPU run on the same castle pairs at 270x480, clean and photometric:
    the statistics within 1e-5 (the flow's kernels are bit-exact to their
    plain twins), the same preset, and B4-B6 launched."""
    from rs_sfm_tpu_torch.data.synthetic import apply_photometric
    from rs_sfm_tpu_torch.eval.gate import PHOTOMETRIC, castle_truth
    from rs_sfm_tpu_torch.flow.auto import probe_flow_preset

    truth = castle_truth(270, 480, device="cpu")
    photo = apply_photometric(truth.i2, torch.Generator().manual_seed(1),
                              **PHOTOMETRIC)
    for i2, want_name in ((truth.i2, "variational"), (photo, "robust")):
        want = probe_flow_preset(truth.i1, i2, return_stats=True)
        before = twarp.warp.launches, tsor.sor_sweeps.launches
        got = probe_flow_preset(truth.i1.to(cuda_device),
                                i2.to(cuda_device), return_stats=True)
        assert twarp.warp.launches > before[0]
        assert tsor.sor_sweeps.launches > before[1]
        assert got[0] == want[0] == want_name
        for key, value in want[1].items():
            assert abs(got[1][key] - value) <= 1e-5, (key, got, want)


@pytest.mark.cuda
def test_ransac_xla_engine_scores_on_the_kernel(cuda_device):
    """engine="xla" on CUDA tensors scores with B1: one launch, and the
    same result as engine="pallas" from the same draws."""
    from rs_sfm_tpu_torch.config import ESTIMATION_CONFIG as cfg
    from rs_sfm_tpu_torch.geom.camera import Intrinsics
    from rs_sfm_tpu_torch.solver import pipeline, ransac


    h, w, f = 48, 64, 60.0
    intr = Intrinsics(fx=f, fy=f, cx=w / 2.0, cy=h / 2.0)
    rng = np.random.default_rng(4)
    flow = torch.from_numpy((np.float32([0.8, -0.4]) + rng.normal(
        scale=0.05, size=(h, w, 2))).astype(np.float32)).to(cuda_device)
    px = pipeline.prepare_flow_inputs(flow, intr, 0.9, cfg)
    draws = ransac.sample_valid_indices(
        torch.Generator(device=cuda_device).manual_seed(3), px[4],
        cfg.ransac_trials)
    got = {}
    for engine in ("xla", "pallas"):
        before = tscore.score_hypotheses.launches
        got[engine] = ransac.ransac(*px, use_k=False,
                                    trials=cfg.ransac_trials,
                                    tolerance=cfg.ransac_tol,
                                    sample_indices=draws, engine=engine,
                                    top_j=4)
        assert tscore.score_hypotheses.launches == before + 1
    for a, b in zip(got["xla"], got["pallas"]):
        assert torch.equal(a, b)


def _refine_problem(n=4096, seed=0):
    """RS flow of n points (float64) with noise and outliers, a perturbed
    start: solver/refine.py's input."""
    rng = np.random.default_rng(seed)
    px = rng.uniform(0, 599, size=(n, 2))
    coords = torch.from_numpy((px - 300.0) / 500.0)
    v = torch.tensor([0.02, -0.01, 0.015], dtype=torch.float64)
    w = torch.tensor([0.004, -0.002, 0.008], dtype=torch.float64)
    rho = torch.from_numpy(1.0 / rng.uniform(3.0, 9.0, size=n))
    dy = torch.from_numpy(rng.normal(scale=2.0, size=n))
    alpha = get_alpha(dy, 600, 0.9)
    alpha_k = get_alpha_k(torch.from_numpy(px[:, 1]), dy, 600, 0.9)
    flow = predict_flow(coords, rho, v, w, 0.0, alpha, alpha_k)
    flow = flow + torch.from_numpy(rng.normal(scale=2e-4, size=(n, 2)))
    flow[:64] += torch.tensor([3e-3, -2e-3], dtype=torch.float64)
    mask = torch.from_numpy(rng.uniform(size=(4, n)) > 0.1)
    scale = torch.from_numpy(rng.uniform(0.8, 1.25, size=(4, 1)))
    return ([coords, flow, alpha, alpha_k],
            [mask, v * scale, w / scale, torch.zeros(4, dtype=torch.float64),
             rho[None] * scale])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_refine_xla_on_the_card_matches_cpu(cuda_device, dtype):
    """solver/refine.py (refine_engine="xla"), 4 starts batched, Huber:
    the card against the CPU from the same inputs.  float64 within 1e-9
    (v, w and the cost; the summation order of the Gram products alone
    differs); float32 within the pipeline's float32 gates (v as a
    direction 2e-4, w 1e-5, cost 1e-3 relative)."""
    from rs_sfm_tpu_torch.solver.refine import refine

    shared, starts = _refine_problem()
    kw = dict(optimize_k=False, iterations=20, rel_tol=0.0, loss_delta=1e-3)
    cast = lambda ts, dev: [t.to(dev, dtype) if t.is_floating_point()  # noqa
                            else t.to(dev) for t in ts]
    cpu = refine(*cast(shared, "cpu"), *cast(starts, "cpu"), **kw)
    card = refine(*cast(shared, cuda_device), *cast(starts, cuda_device),
                  **kw)
    assert card.v.is_cuda and card.v.dtype == dtype
    v_tol, w_tol, c_tol = ((1e-9, 1e-9, 1e-9) if dtype == torch.float64
                           else (2e-4, 1e-5, 1e-3))
    unit = lambda v: v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)  # noqa
    torch.testing.assert_close(unit(card.v.cpu()), unit(cpu.v), rtol=0,
                               atol=v_tol)
    torch.testing.assert_close(card.w.cpu(), cpu.w, rtol=0, atol=w_tol)
    torch.testing.assert_close(card.cost.cpu(), cpu.cost, rtol=c_tol, atol=0)
    assert bool((card.cost < card.initial_cost).all())


def _castle_pair_data(size):
    from rs_sfm_tpu_torch.data import synthetic as syn
    from rs_sfm_tpu_torch.data.dataset import FrameData, PairData

    intr = syn.default_intrinsics(size, size)
    p = syn.render_pair(syn.castle_scene(torch.float32, "cpu"), intr, size,
                        size, gamma=0.9, k=0.0, v=(0.12, -0.05, 0.08),
                        w=(0.003, -0.002, 0.004))

    def frame(fr):
        return FrameData(rs_image=fr.rs_image.numpy(),
                         gs_image=fr.gs_image.numpy(), depth_image=None,
                         poses_r=fr.poses_r.numpy(),
                         poses_t=fr.poses_t.numpy(),
                         rs_unproject=fr.rs_unproject.numpy(),
                         gs_unproject=fr.gs_unproject.numpy())

    return PairData(frame(p.frame1), frame(p.frame2), intr, gamma=0.9, k=0.0,
                    v=p.v.numpy(), w=p.w.numpy())


@pytest.mark.cuda
def test_harness_on_the_card_matches_cpu(cuda_device):
    """evaluate_velocities_batched at 64x64, 2 evaluations of the default
    ("xla") configuration, the same draws on both devices (RANSAC scores
    on B1 on the card, so the CPU side scores with its plain version, the
    "pallas" engine): v as a direction within 2e-4, w within 1e-5, err3d
    within 1e-3 relative, inlier counts within 0.1 % of the pixels;
    tests/test_harness.py's gates on the card."""
    import dataclasses

    from rs_sfm_tpu_torch.config import PipelineConfig
    from rs_sfm_tpu_torch.eval import harness
    from rs_sfm_tpu_torch.solver.pipeline import prepare_flow_inputs
    from rs_sfm_tpu_torch.solver.ransac import sample_valid_indices

    pair = _castle_pair_data(64)
    cfg = PipelineConfig(ransac_trials=32, ransac_tol=0.01,
                         refine_iterations=20)
    flow = harness.compute_flow(pair, device="cpu")
    valid = prepare_flow_inputs(flow, pair.intrinsics, 0.9, cfg)[4]
    gen = torch.Generator().manual_seed(5)
    idx = torch.stack([sample_valid_indices(gen, valid, cfg.ransac_trials)
                       for _ in range(2)])
    cpu_cfg = dataclasses.replace(cfg, ransac_engine="pallas")
    got = {dev: harness.evaluate_velocities_batched(
        pair, c, num_evaluations=2, sample_indices=idx, device=dev)
        for dev, c in (("cpu", cpu_cfg), (cuda_device, cfg))}
    cpu, card = got["cpu"], got[cuda_device]
    unit = lambda v: v / np.linalg.norm(v, axis=0, keepdims=True)  # noqa
    np.testing.assert_allclose(unit(card.v), unit(cpu.v), rtol=0, atol=2e-4)
    np.testing.assert_allclose(card.w, cpu.w, rtol=0, atol=1e-5)
    np.testing.assert_allclose(card.error_reproject_vec,
                               cpu.error_reproject_vec, rtol=1e-3)
    assert np.abs(card.num_inliers - cpu.num_inliers).max() <= 1e-3 * 64 * 64
    assert card.error_w < 1e-3 and card.error_v < 0.02
    assert card.error_reproject < 0.2


@pytest.mark.cuda
def test_png_round_trip_of_a_card_image(cuda_device, tmp_path):
    """A frame rendered on the card, written by data/png.py and read back:
    the same pixels as the render's uint8 copy."""
    from rs_sfm_tpu_torch.data import png, synthetic as syn
    from rs_sfm_tpu_torch.data.dataset import to_uint8

    p = syn.render_pair(syn.castle_scene(torch.float32, cuda_device),
                        syn.default_intrinsics(40, 56), 40, 56, gamma=0.9,
                        k=0.0, v=(0.12, -0.05, 0.08),
                        w=(0.003, -0.002, 0.004))
    assert p.frame1.rs_image.is_cuda
    img = to_uint8(p.frame1.rs_image)
    png.write(str(tmp_path / "f.png"), img)
    back = png.read(str(tmp_path / "f.png"))
    np.testing.assert_array_equal(back, img)
    np.testing.assert_array_equal(
        back, np.clip(np.round(p.frame1.rs_image.cpu().numpy() * 255.0), 0,
                      255).astype(np.uint8))


@pytest.mark.cuda
def test_cli_single_run_on_the_card(cuda_device, tmp_path, capsys):
    """`generate --size 64` and `single-run` (the default configuration on
    the GT flow) with --device cuda, held to tests/test_harness.py's
    gates."""
    import json

    from rs_sfm_tpu_torch import cli

    ds, out = tmp_path / "ds", tmp_path / "res"
    cli.main(["generate", "--out", str(ds), "--size", "64"])
    cli.main(["single-run", "--data", str(ds), "--out", str(out),
              "--ransac-trials", "32", "--ransac-tol", "0.01"])
    est = json.loads((out / "estimate.json").read_text())
    v, v_true = np.array(est["v"]), np.array([0.12, -0.05, 0.08])
    cos = abs(v @ v_true) / np.linalg.norm(v) / np.linalg.norm(v_true)
    assert np.arccos(min(cos, 1.0)) < 0.02
    assert np.abs(np.array(est["w"]) - [0.003, -0.002, 0.004]).max() < 1e-3
    text = capsys.readouterr().out
    assert float(text.split("mean reprojection error:")[1].split()[0]) < 0.2
    assert (out / "point_cloud.ply").exists()


def _accel_problem(device, n_side=64, k=0.6, trials=64, seed=4):
    """The prepared inputs of a noise-free RS flow of random depths under
    an accelerating motion (k), float32 on `device`, and `trials` 9-point
    draws from it."""
    from rs_sfm_tpu_torch.config import PipelineConfig
    from rs_sfm_tpu_torch.geom.camera import Intrinsics
    from rs_sfm_tpu_torch.solver.pipeline import prepare_flow_inputs

    rng = np.random.default_rng(seed)
    f, gamma = 60.0, 0.9
    ys, xs = np.meshgrid(np.arange(n_side, dtype=np.float64),
                         np.arange(n_side, dtype=np.float64), indexing="ij")
    coords = torch.from_numpy(np.stack([xs - n_side / 2.0,
                                        ys - n_side / 2.0], -1).reshape(-1, 2)
                              / f)
    rho = torch.from_numpy(1.0 / rng.uniform(4.0, 9.0, size=n_side ** 2))
    v = torch.tensor([0.2, -0.1, 0.15], dtype=torch.float64)
    w = torch.tensor([0.003, -0.002, 0.004], dtype=torch.float64)
    yy = torch.from_numpy(ys.reshape(-1))
    fl = torch.zeros((n_side ** 2, 2), dtype=torch.float64)
    for _ in range(6):
        a = get_alpha(fl[:, 1] * f, n_side, gamma)
        ak = get_alpha_k(yy, fl[:, 1] * f, n_side, gamma)
        fl = predict_flow(coords, rho, v, w, k, a, ak)
    flow = (fl * f).reshape(n_side, n_side, 2).float().to(device)
    inputs = prepare_flow_inputs(
        flow, Intrinsics(fx=f, fy=f, cx=n_side / 2.0, cy=n_side / 2.0),
        gamma, PipelineConfig())
    draws = torch.from_numpy(rng.integers(0, n_side ** 2, size=(trials, 9)))
    return inputs, draws.to(device)


@pytest.mark.cuda
def test_score_kernel_all_k_hypotheses(cuda_device):
    """B1 on the acceleration model's hypotheses: every root of det Z(k) of
    64 samples (384 rows, k != 0), the complex roots' slots zero motion,
    counts equal to the plain version's."""
    from rs_sfm_tpu_torch.solver.minimal import calculate_velocities_all_k

    (coords, flow_n, alpha, alpha_k, valid), draws = _accel_problem(
        cuda_device)
    f64 = torch.float64
    w6, v6, k6, ok = calculate_velocities_all_k(
        *(t[draws].to(f64) for t in (coords, flow_n, alpha, alpha_k)))
    ok = ok.reshape(-1)
    assert ok.any() and not ok.all()
    hy = tscore.pack_hyps(torch.where(ok[:, None], v6.reshape(-1, 3), 0.0),
                          torch.where(ok[:, None], w6.reshape(-1, 3), 0.0),
                          k6.reshape(-1))
    px = tscore.pack_pixels(coords, flow_n, alpha, alpha_k, valid)
    num_k, err_k = tscore.score_hypotheses(px, hy, TOL)
    num_p, err_p = tscore.score_hypotheses_plain(px, hy, TOL)
    torch.cuda.synchronize()
    assert torch.equal(num_k, num_p)
    np.testing.assert_allclose(err_k.cpu().numpy(), err_p.cpu().numpy(),
                               rtol=1e-5, atol=1e-6)
    assert float(num_k.max()) > 0.9 * valid.sum().item()


@pytest.mark.cuda
@pytest.mark.parametrize("prescore", [0, 512])
def test_ransac_all_k_on_the_card(cuda_device, prescore):
    """The acceleration model's RANSAC on the card: B1 scores the prescore's
    subsample and the shortlist (one launch each), the pick's count equals
    its plain scoring's, and k is the motion's."""
    from rs_sfm_tpu_torch.solver.ransac import ransac

    (coords, flow_n, alpha, alpha_k, valid), draws = _accel_problem(
        cuda_device)
    before = tscore.score_hypotheses.launches
    rr = ransac(coords, flow_n, alpha, alpha_k, valid, use_k=True,
                trials=64, tolerance=TOL, sample_indices=draws,
                prescore_subsample=prescore, top_j=4)
    torch.cuda.synchronize()
    assert tscore.score_hypotheses.launches == before + (2 if prescore
                                                         else 1)
    px = tscore.pack_pixels(coords, flow_n, alpha, alpha_k, valid)
    num, _ = tscore.score_hypotheses_plain(
        px, tscore.pack_hyps(rr.v[None], rr.w[None], rr.k.reshape(1)), TOL)
    assert int(num[0]) == int(rr.num_inliers) > 0.9 * valid.sum().item()
    assert abs(float(rr.k) - 0.6) < 1e-3
    assert rr.top_v.shape == (4, 3) and torch.isfinite(rr.top_k).all()


@pytest.mark.cuda
@pytest.mark.parametrize("j", [1, 4])
def test_lm_refinement_with_k_free_matches_plain(cuda_device, j):
    """20 iterations of the fused refinement with k free (B2 at J = 1, B3
    at J = 4) on the card against the same loop on the CPU (the plain
    twins): v direction, w, k and the cost within rtol 1e-4 (float32 sums in
    two orders), as chip_smoke.py's phase 3."""
    from rs_sfm_tpu_torch.solver import refine_fused as rf

    st, px, masks, rho = _lm_problem(j)
    coords, flow = px[0:2].T.contiguous(), px[2:4].T.contiguous()
    alpha, alpha_k = px[4].contiguous(), px[5].contiguous()
    v0, w0, k0 = st[:, 0:3], st[:, 3:6], st[:, 6]
    kw = dict(optimize_k=True, iterations=20, rel_tol=0.0, loss_delta=HUBER)

    def run(device):
        args = [t.to(device) for t in (coords, flow, alpha, alpha_k)]
        m = masks.to(device) > 0.5
        if j == 1:
            res = rf.refine_pallas(*args, m[0], v0[0].to(device),
                                   w0[0].to(device), k0[0].to(device),
                                   rho[0].to(device), **kw)
            return [t.reshape(1, -1).cpu().numpy().astype(np.float64)
                    for t in (res.v, res.w, res.k, res.cost)]
        res = rf.refine_pallas_multi(*args, m, v0.to(device), w0.to(device),
                                     k0.to(device), rho.to(device), **kw)
        return [t.reshape(j, -1).cpu().numpy().astype(np.float64)
                for t in (res.v, res.w, res.k, res.cost)]

    name = "lm_iter" if j == 1 else "lm_iter_multi"
    before = getattr(trk, name).launches
    got = run(cuda_device)
    assert getattr(trk, name).launches == before + 21
    want = run("cpu")
    unit = lambda v: v / np.linalg.norm(v, axis=-1, keepdims=True)  # noqa
    np.testing.assert_allclose(unit(got[0]), unit(want[0]), rtol=1e-4,
                               atol=1e-6)
    for g, wv in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, wv, rtol=1e-4, atol=0)
    assert np.all(got[2][:, 0] != st[:, 6].numpy())  # k moved
