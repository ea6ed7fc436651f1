"""Discrete flow search: the CUDA kernel (csrc/match.cu) and its plain
PyTorch twin.

The JAX package's warp-local refine (rs_sfm_tpu/flow/dense.py::
_discrete_refine) and coarse integer search (::_coarse_init) scan
(2r+1)^2 integer candidates per pixel, each through the TPU warp kernel
rs_sfm_tpu/ops/pallas/warp.py::bilinear_warp (exact refine) or an integer
shift (coarse, shifted refine), a squared difference, a 5x5 box sum and
the best / second-best update.  `match_search` runs one such search in
one launch; `match_search_plain` is the search as the port ran it before
the kernel existed: chunks of candidates through `warp_plain` (refine) or
edge-padded slices (coarse, shifted), `box5` and `_scan`, in the same
operation order.

Modes:
  * refine (`flow` an (H, W, 2) tensor): candidate k is flow + d_k,
    rounded to float32, and I2 is sampled bilinearly at x + candidate,
    edge-clamped (warp_plain's operation order);
  * coarse (`flow` None): candidate k is d_k, and I2 is read at
    (clip(y + dv), clip(x + du));
  * shifted (`flow` a tensor and `shifted`): I2 is the plane already
    warped once by the flow; candidate k is flow + d_k, as in refine, and
    I2 is read as in coarse (rs_sfm_tpu/flow/dense.py:555-561).
Candidate k = dy * side + dx has offset d_k = (dx - r, dy - r).

With a prior (an (H, W, 2) flow, the relock pass's model flow), each
candidate's selection cost is its raw cost times
1 + 0.35 d2 / (d2 + max(r, 1)^2), d2 its squared distance to the prior
(dense.py::_prior_factor): exact photometric ties resolve toward the
prior.  The second best and the ambiguity mask keep the raw costs, and the
ratio fallback is skipped (dense.py::_match_scan).
"""

from __future__ import annotations

import ctypes

import torch

from rs_sfm_tpu_torch.ops import stencil
from rs_sfm_tpu_torch.ops.kernels import _build
from rs_sfm_tpu_torch.ops.kernels.sor import H100_LIMITS, card_limits
from rs_sfm_tpu_torch.ops.kernels.warp import aligned8, warp_plain

# Ambiguity threshold of the exported mask (rs_sfm_tpu/flow/dense.py:431).
AMB_RATIO = 0.9
# The prior's tie-break strength (rs_sfm_tpu/flow/dense.py:437).
PRIOR_W = 0.35
# Candidate costs the plain version computes at once: bounds its (K, H, W)
# temporaries.
_CHUNK_ELEMENTS = 1 << 24

# csrc/match.cu's tiles (rows, columns), by plan index.
TILES = ((8, 32), (8, 16), (8, 8), (4, 8))


def candidates(radius: int):
    """The (2r+1)^2 integer offsets (du, dv) in the JAX scan's order:
    k = dy * side + dx, offset (dx - r, dy - r)."""
    side = 2 * radius + 1
    return [(float(k % side - radius), float(k // side - radius))
            for k in range(side * side)]


def box5(x):
    """5x5 box sum over the last two axes, edge-clamped: axis -2 first,
    each 5-sum x[i+2] + x[i+1] + x[i] + x[i-1] + x[i-2] left to right."""
    for axis in (-2, -1):
        x = (stencil.shift(x, -2, axis) + stencil.shift(x, -1, axis) + x
             + stencil.shift(x, 1, axis) + stencil.shift(x, 2, axis))
    return x


def prior_factor(d2, radius: int):
    """The selection-cost factor 1 + 0.35 d2 / (d2 + max(radius, 1)^2) of
    a candidate at squared distance d2 from the prior, in the operation
    order of rs_sfm_tpu/flow/dense.py::_prior_factor."""
    s2 = float(max(radius, 1)) ** 2
    return 1.0 + (PRIOR_W * d2) / (d2 + s2)


def _scan(cost_chunks, cand_of, shape, dtype, device, *, ratio=0.0,
          fallback=None, prior=None, radius=1):
    """The (2r+1)^2 scan of rs_sfm_tpu/flow/dense.py::_match_scan.

    cost_chunks yields (K_c, H, W) raw match costs in candidate order;
    cand_of(k) gives candidate k's flow (u, v) (planes or numbers); prior
    an optional (H, W, 2) flow that scales the selection costs.
    Returns (best (H, W, 2), second (H, W, 2), ambiguous (H, W) bool).
    """
    inf = torch.full(shape, torch.inf, dtype=dtype, device=device)
    zero = torch.zeros(shape, dtype=dtype, device=device)
    best_sel, best_cost, second_cost = inf, inf, inf
    best_u = best_v = second_u = second_v = zero
    k = 0
    for costs in cost_chunks:
        for cost in costs:
            cu, cv = cand_of(k)
            k += 1
            sel = cost
            if prior is not None:
                eu = cu - prior[..., 0]
                ev = cv - prior[..., 1]
                sel = cost * prior_factor(eu * eu + ev * ev, radius)
            better = sel < best_sel
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
            best_sel = torch.where(better, sel, best_sel)
            best_u = torch.where(better, cu, best_u)
            best_v = torch.where(better, cv, best_v)
    best = torch.stack([best_u, best_v], dim=-1)
    second = torch.stack([second_u, second_v], dim=-1)
    amb = best_cost >= AMB_RATIO * second_cost
    if ratio > 0.0 and fallback is not None and prior is None:
        ok = best_cost < ratio * second_cost
        best = torch.where(ok[..., None], best, fallback)
    return best, second, amb


def _chunks(n: int, h: int, w: int):
    step = max(1, _CHUNK_ELEMENTS // (h * w))
    return [(a, min(n, a + step)) for a in range(0, n, step)]


def _check(i1m, i2m, flow, radius, fallback, prior=None, shifted=False):
    if shifted and flow is None:
        raise ValueError("the shifted search needs the flow")
    if i1m.dim() != 2 or i2m.shape != i1m.shape:
        raise ValueError(f"i1m and i2m must be one (H, W) shape, got "
                         f"{tuple(i1m.shape)} and {tuple(i2m.shape)}")
    field = tuple(i1m.shape) + (2,)
    named = (("flow", flow), ("fallback", fallback), ("prior", prior))
    for name, t in named:
        if t is not None and tuple(t.shape) != field:
            raise ValueError(f"{name} must be {field}, got {tuple(t.shape)}")
    for name, t in (("i1m", i1m), ("i2m", i2m)) + named:
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != i1m.device:
            raise ValueError(f"{name} on {t.device}, i1m on {i1m.device}")
    if radius < 0:
        raise ValueError(f"radius must be >= 0, got {radius}")


def match_search_plain(i1m, i2m, flow, radius: int, ratio: float = 0.0,
                       fallback=None, prior=None, shifted: bool = False):
    """Plain PyTorch version of `match_search` (same arguments)."""
    _check(i1m, i2m, flow, radius, fallback, prior, shifted)
    h, w = i1m.shape
    offs = candidates(radius)
    if flow is None or shifted:
        padded = stencil.pad_edge(i2m, radius)

        def cost_chunks():
            for a, b in _chunks(len(offs), h, w):
                moved = torch.stack([
                    padded[int(dv) + radius:int(dv) + radius + h,
                           int(du) + radius:int(du) + radius + w]
                    for du, dv in offs[a:b]])
                d = moved - i1m
                yield box5(d * d)
    else:
        off_t = torch.tensor(offs, dtype=flow.dtype, device=flow.device)

        def cost_chunks():
            for a, b in _chunks(len(offs), h, w):
                cand = flow[None] + off_t[a:b, None, None, :]
                d = warp_plain(i2m, cand) - i1m
                yield box5(d * d)

    if flow is None:
        def cand_of(k):
            return offs[k]
    else:
        fu, fv = flow[..., 0], flow[..., 1]

        def cand_of(k):
            du, dv = offs[k]
            return fu + du, fv + dv

    return _scan(cost_chunks(), cand_of, (h, w), i1m.dtype, i1m.device,
                 ratio=ratio, fallback=fallback, prior=prior, radius=radius)


# csrc/match.cu's MARGIN: pixels of flow variation about a tile's centre
# that its staged window of I2 covers.
MARGIN = 8


def smem_bytes(tile: int, radius: int) -> int:
    """Shared-memory bytes of one block of csrc/match.cu on plan tile
    `tile`, in the refine mode (the coarse one takes less): the flow and
    I1 on the tile's halo, the window of I2, and d2, row sums and costs for
    one row of 2r + 1 candidates."""
    th, tw = TILES[tile]
    halo = (th + 4) * (tw + 4)
    window = ((th + 5 + 2 * (radius + MARGIN))
              * (tw + 5 + 2 * (radius + MARGIN)))
    return 4 * (3 * halo + window + (2 * radius + 1) * (
        halo + th * (tw + 4) + th * tw))


def tile_plan(h: int, w: int, radius: int, limits=H100_LIMITS) -> int:
    """The tile (index into TILES) of csrc/match.cu for an (h, w) search of
    `radius` on a card of `limits` (sor.card_limits): the largest that
    gives at least 1.5 blocks an SM, else the smallest (measured on an H100
    at the e2e searches, PERF.md section 6: 8x16 at 135x240, 4x8 below)."""
    sms, smem = limits
    fits = [t for t in range(len(TILES)) if smem_bytes(t, radius) <= smem]
    if not fits:
        raise ValueError(f"radius {radius}: a row of candidates does not "
                         f"fit in {smem} bytes of shared memory")
    for t in fits:
        th, tw = TILES[t]
        if 2 * (-(-h // th) * -(-w // tw)) >= 3 * sms:
            return t
    return fits[-1]


def _lib():
    lib = _build.load("match")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.match_launch.argtypes = [p, p, p, i, p, p, p, p, p, i, i, i,
                                     ctypes.c_float, i, p]
        lib.match_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def match_launch(i1m, i2m, flow, radius: int, ratio: float, fallback,
                 tile: int, prior=None, shifted: bool = False):
    """One search by csrc/match.cu on tile `tile` (an index into TILES),
    from CUDA tensors; returns (best, second, ambiguous) like
    `match_search`.  Not counted in `match_search.launches`."""
    h, w = i1m.shape
    i1m, i2m = i1m.contiguous(), i2m.contiguous()
    flow, fallback, prior = (None if t is None else aligned8(t)
                             for t in (flow, fallback, prior))
    use_fb = ratio > 0.0 and fallback is not None and prior is None
    dev = i1m.device
    lib = _lib()
    with torch.cuda.device(dev):
        best = torch.empty((h, w, 2), dtype=torch.float32, device=dev)
        second = torch.empty((h, w, 2), dtype=torch.float32, device=dev)
        amb = torch.empty((h, w), dtype=torch.bool, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib.match_launch(
            i1m.data_ptr(), i2m.data_ptr(),
            None if flow is None else flow.data_ptr(), int(shifted),
            fallback.data_ptr() if use_fb else None,
            None if prior is None else prior.data_ptr(), best.data_ptr(),
            second.data_ptr(), amb.data_ptr(), h, w, radius,
            float(ratio) if use_fb else 0.0, tile, stream), "match_launch")
    return best, second, amb


def match_search(i1m, i2m, flow, radius: int, ratio: float = 0.0,
                 fallback=None, prior=None, shifted: bool = False):
    """One discrete search of radius `radius` (see the module docstring).

    Args:
      i1m, i2m: (H, W) float32 matching planes of frames 1 and 2 (with
        `shifted`, frame 2's warped by `flow`).
      flow: (H, W, 2) float32 flow around which to search (refine), or
        None for the search over integer shifts (coarse).
      shifted: the shifted refine (see the module docstring).
      radius: candidates per axis 2 * radius + 1.
      ratio, fallback: where ratio > 0 and fallback ((H, W, 2)) is given
        and prior is None, a pixel whose best cost is not below ratio x
        the second's takes the fallback's flow.
      prior: optional (H, W, 2) float32 flow that scales each candidate's
        selection cost by its distance (see the module docstring).

    Returns (best (H, W, 2), second (H, W, 2), ambiguous (H, W) bool):
    the best candidate, the best one more than 1.5 px (max-norm) from it,
    and best cost >= 0.9 x second cost.

    On CUDA tensors this launches the kernel of csrc/match.cu (counted in
    `match_search.launches`, and in `match_search.shifted_launches` in the
    shifted mode); on CPU tensors it runs `match_search_plain`.
    """
    _check(i1m, i2m, flow, radius, fallback, prior, shifted)
    if i1m.device.type == "cpu":
        return match_search_plain(i1m, i2m, flow, radius, ratio, fallback,
                                  prior, shifted)
    if i1m.device.type != "cuda":
        raise ValueError(f"unsupported device {i1m.device}")
    h, w = i1m.shape
    out = match_launch(i1m, i2m, flow, radius, ratio, fallback,
                       tile_plan(h, w, radius, card_limits(i1m.device)),
                       prior, shifted)
    match_search.launches += 1
    match_search.shifted_launches += shifted
    return out


match_search.launches = 0
# The launches of match_search.launches in the shifted mode.
match_search.shifted_launches = 0
