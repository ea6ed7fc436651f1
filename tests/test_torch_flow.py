"""Dense flow: rs_sfm_tpu_torch vs the JAX package on the CPU, float32.

Kernels B4-B6 through their plain twins (the wrappers run them on CPU
tensors):
  * B6 median: bit-exact to `_median3` and to the Pallas kernel
    (interpret mode), min/max only;
  * B4 warp: bit-exact to `_warp`, flows leaving the image included (the
    same IEEE operations in the same order);
  * B5 SOR: the plain twin is the TPU kernel's absolute form, held to the
    JAX XLA loop (delta form) through `dense_flow` at one level within
    1e-3 px, the bound the JAX package holds its own kernel to.
Then `flow_forward_backward` with the variational preset and the
half-resolution backward pass at 64x128 against the JAX package's XLA
engines.  The SOR formulations and XLA's fused multiply-adds differ at
float32 rounding, and at exact or near ties of a discrete search (pixels
whose samples all clamp to the same edge) that flips the chosen integer
candidate: forward EPE median <= 1e-3 px and p99 <= 0.1 px, p99 <= 0.02 px
on the pixels JAX finds unambiguous, backward p99 <= 1e-3 px, occlusion
masks differing on <= 0.5 % of pixels and ambiguity masks equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from rs_sfm_tpu.flow import dense as jdense
from rs_sfm_tpu.models import get_flow_preset as jget_preset
from rs_sfm_tpu.ops.pallas.median import median3_planes as jmedian_pallas
from rs_sfm_tpu_torch import config as tconfig
from rs_sfm_tpu_torch.data.make_flow import make_flow
from rs_sfm_tpu_torch.flow import dense as tdense
from rs_sfm_tpu_torch.models import get_flow_preset
from rs_sfm_tpu_torch.ops.kernels import match as tmatch
from rs_sfm_tpu_torch.ops.kernels import median as tmedian
from rs_sfm_tpu_torch.ops.kernels import sor as tsor
from rs_sfm_tpu_torch.ops.kernels import warp as twarp

# The test workers share the CPU with the JAX tests: a few intra-op threads
# each (the results do not depend on the count).
torch.set_num_threads(2)


def _smooth_pair(h, w, seed=0, shift=(2, -2)):
    """A textured plane and a copy shifted by `shift` (rows, cols)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.1, 0.9, (h + 8, w + 8)).astype(np.float32)
    for _ in range(2):
        for ax in (0, 1):
            base = (np.roll(base, 1, ax) + 2 * base
                    + np.roll(base, -1, ax)) / 4.0
    dy, dx = shift
    i1 = base[4:4 + h, 4:4 + w].copy()
    i2 = base[4 - dy:4 - dy + h, 4 - dx:4 - dx + w].copy()
    return i1, i2


def test_median_plain_is_bit_exact_to_jax():
    """(2, 45, 77): odd rows and columns, not a multiple of the Pallas
    kernel's 120-row block or 128-lane tile."""
    x = np.random.default_rng(11).normal(size=(2, 45, 77)).astype(np.float32)
    got = tmedian.median3_planes(torch.from_numpy(x)).numpy()
    ref = np.stack([np.asarray(jdense._median3(jnp.asarray(p))) for p in x])
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        got, np.asarray(jmedian_pallas(jnp.asarray(x), interpret=True)))


def _median_data(h, w, seed):
    """(2, h, w) float32 with ties and zeros of both signs."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, h, w)).astype(np.float32)
    x[:, ::2, ::3] = 0.0
    x[:, 1::2, ::3] = -0.0
    x[0, :, 1::4] = 0.5
    x[1, ::3, :] = np.round(x[1, ::3, :])
    return x


def _bits(t):
    return t.contiguous().numpy().view(np.uint32)


@pytest.mark.parametrize("h,w", [(1, 1), (2, 3), (17, 30), (34, 60)])
def test_median_flow_is_bit_exact_to_plain(h, w):
    """The flow solver's median (`_median_flow` over median3_flow) reads
    the planes where they lie -- two separate planes, or the halves of an
    (H, W, 2) flow -- and returns a contiguous (H, W, 2) flow equal bit for
    bit (signed zeros included) to median3_plain of the planes.  The
    strides the CUDA launch would read the planes with address them."""
    x = _median_data(h, w, seed=h * 1000 + w)
    planes = torch.from_numpy(x)
    ref = tmedian.median3_plain(planes).permute(1, 2, 0)
    flow = planes.permute(1, 2, 0).contiguous()
    for u, v, kind in ((planes[0], planes[1], "planes"),
                       (planes[0].clone(), planes[1].clone(), "planes"),
                       (flow[..., 0], flow[..., 1], "pair")):
        got = tdense._median_flow(u, v)
        assert got.shape == (h, w, 2) and got.is_contiguous()
        np.testing.assert_array_equal(_bits(got), _bits(ref))
        layout = tmedian._pair_layout(u, v)
        assert layout[0] == kind or h * w == 1  # 1x1: either reads both
        kind = layout[0]
        if u.untyped_storage().data_ptr() != v.untyped_storage().data_ptr():
            continue  # two buffers: the plane stride spans them
        base = torch.tensor([], dtype=torch.float32).set_(
            u.untyped_storage())
        off = u.storage_offset()
        if kind == "pair":
            seen = base.as_strided((h, w, 2), (layout[1], 2, 1), off)
        else:
            seen = base.as_strided((2, h, w), (layout[1], layout[2], 1),
                                   off).permute(1, 2, 0)
        assert torch.equal(seen, torch.stack([u, v], dim=-1))
    if w > 1:  # swapped halves have column stride 2: not readable as is
        assert tmedian._pair_layout(flow[..., 1], flow[..., 0]) is None


def test_warp_plain_is_bit_exact_to_jax():
    """Flows of up to +-w/2 px push samples off every edge; one plane by
    one field, by a batch of fields, and two planes by one field."""
    rng = np.random.default_rng(4)
    h, w = 37, 61
    img = _smooth_pair(h, w, seed=4)[0]
    flows = rng.uniform(-w / 2, w / 2, (3, h, w, 2)).astype(np.float32)
    # Op by op, as written: under jit XLA's CPU backend contracts the
    # blend into fused multiply-adds (up to 2 ulp from the IEEE order).
    jwarp = jdense._warp
    refs = np.stack([np.asarray(jwarp(jnp.asarray(img), jnp.asarray(f)))
                     for f in flows])
    img_t = torch.from_numpy(img)
    flows_t = torch.from_numpy(flows)
    np.testing.assert_array_equal(twarp.warp(img_t, flows_t[0]).numpy(),
                                  refs[0])
    np.testing.assert_array_equal(twarp.warp(img_t, flows_t).numpy(), refs)
    two = twarp.warp(torch.stack([img_t, 2.0 * img_t]), flows_t[1]).numpy()
    np.testing.assert_array_equal(two[0], refs[1])
    np.testing.assert_array_equal(
        two[1], np.asarray(jwarp(jnp.asarray(2.0 * img),
                                 jnp.asarray(flows[1]))))


def test_sor_plain_matches_jax_xla_loop():
    """One pyramid level, no discrete search: the flow is the 3 warps x 20
    sweeps of red-black SOR (and medians) alone, at 98x200."""
    i1, i2 = _smooth_pair(98, 200, seed=7)
    cfg = dict(levels=1, init_search_radius=0, refine_search_radius=0)
    ref = np.asarray(jdense.dense_flow(jnp.asarray(i1), jnp.asarray(i2),
                                       jdense.DenseFlowConfig(**cfg)))
    got = tdense.dense_flow(torch.from_numpy(i1), torch.from_numpy(i2),
                            tdense.DenseFlowConfig(**cfg))
    assert np.abs(got.numpy() - ref).max() < 1e-3
    assert np.abs(ref).max() > 0.5  # the solver moved the flow


H, W = 64, 128


@pytest.fixture(scope="module")
def fb_pair():
    """bench.py's input at 64x128: channel 0 of the seed-0 uniform image
    and its warp by a smooth flow (half of make_flow)."""
    i1 = np.random.default_rng(0).uniform(0.1, 0.9, (H, W, 3)).astype(
        np.float32)[..., 0]
    for ax in (0, 1):
        i1 = ((np.roll(i1, 1, ax) + 2 * i1 + np.roll(i1, -1, ax)) / 4
              ).astype(np.float32)
    flow = 0.5 * make_flow(H, W)
    i2 = twarp.warp_plain(torch.from_numpy(i1), torch.from_numpy(flow))
    return i1, i2.numpy(), flow


@pytest.fixture(scope="module")
def fb_results(fb_pair):
    i1, i2, _ = fb_pair
    jcfg = jget_preset("variational", backward_scale=2)
    rj = jdense.flow_forward_backward(jnp.asarray(i1), jnp.asarray(i2), jcfg)
    rj = {k: np.asarray(getattr(rj, k)) for k in rj._fields}
    rt = tdense.flow_forward_backward(torch.from_numpy(i1),
                                      torch.from_numpy(i2),
                                      tconfig.E2E_FLOW_PRESET)
    return rj, rt


def test_flow_forward_backward_matches_jax(fb_pair, fb_results):
    rj, rt = fb_results
    epe = np.linalg.norm(rt.flow.numpy() - rj["flow"], axis=-1)
    assert np.median(epe) <= 1e-3 and np.percentile(epe, 99) <= 0.1, (
        np.median(epe), np.percentile(epe, 99))
    assert np.percentile(epe[~rj["ambiguous"]], 99) <= 0.02
    epe_b = np.linalg.norm(rt.backward.numpy() - rj["backward"], axis=-1)
    assert np.percentile(epe_b, 99) <= 1e-3
    assert (rt.occlusion.numpy() != rj["occlusion"]).mean() <= 5e-3
    np.testing.assert_array_equal(rt.ambiguous.numpy(), rj["ambiguous"])
    # The flow is real: i2(x) = i1(x + f(x)), so the flow is about -f.
    truth = np.linalg.norm(rt.flow.numpy() + fb_pair[2], axis=-1)
    assert np.median(truth[~rt.occlusion.numpy()]) < 0.5


@pytest.mark.parametrize("engine", ["pallas", "xla"])
def test_flow_goes_through_the_kernel_wrappers(fb_pair, monkeypatch, engine):
    """The main path calls B4-B6 as often as chip_smoke.py's count, which
    it asserts against the launch counters on the card (the SOR wrapper
    launches `launches_per_call` kernels per call), whichever engine names
    the config carries over from JAX.  Each discrete search is one
    `match_search` launch and no `warp` launch."""
    calls = {"warp": 0, "match_search": 0, "sor_sweeps": 0,
             "median3_planes": 0}

    def spy(name, fn, weight):
        def wrapped(*args, **kwargs):
            calls[name] += weight(args, kwargs)
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(twarp, "warp",
                        spy("warp", twarp.warp, lambda a, kw: 1))
    monkeypatch.setattr(tmatch, "match_search",
                        spy("match_search", tmatch.match_search,
                            lambda a, kw: 1))
    monkeypatch.setattr(tsor, "sor_sweeps",
                        spy("sor_sweeps", tsor.sor_sweeps,
                            lambda a, kw: tsor.launches_per_call(
                                *a[1].shape, kw["iters"])))
    # Both median entry points launch the one kernel that chip_smoke.py
    # counts as median3_planes.
    for fn in ("median3_planes", "median3_flow"):
        monkeypatch.setattr(tmedian, fn, spy("median3_planes",
                                             getattr(tmedian, fn),
                                             lambda a, kw: 1))
    i1, i2, _ = fb_pair
    cfg = tconfig.E2E_FLOW_PRESET._replace(iters=2, warps_coarse=2,
                                           warp_engine=engine,
                                           sor_engine=engine)
    tdense.flow_forward_backward(torch.from_numpy(i1), torch.from_numpy(i2),
                                 cfg)
    expect = chip_smoke.flow_launches(cfg, H, W)
    assert calls == expect
    # Forward levels 64x128, 32x64, 16x32; backward 32x64, 16x32: a coarse
    # search and a refine at each level but the finest, and 2 warps a level
    # (3 on the finest), plus the occlusion warp.
    assert calls["match_search"] == (1 + 2) + (1 + 1)
    assert calls["warp"] == (2 + 2 + 3) + (2 + 3) + 1
    assert all(n > 0 for n in calls.values())


@pytest.mark.parametrize("change", [
    dict(census_weight=1.0), dict(refine_shifted=True),
    dict(anchor_ambiguous=True)])
def test_unported_flow_options_raise(change):
    i1, i2 = _smooth_pair(32, 48)
    cfg = tdense.DenseFlowConfig(**change)
    with pytest.raises(NotImplementedError):
        tdense.dense_flow(torch.from_numpy(i1), torch.from_numpy(i2), cfg)


def test_prior_and_auto_preset_raise():
    i1, i2 = _smooth_pair(32, 48)
    with pytest.raises(NotImplementedError):
        tdense.flow_forward_backward(torch.from_numpy(i1),
                                     torch.from_numpy(i2),
                                     prior=torch.zeros(32, 48, 2))
    with pytest.raises(NotImplementedError):
        get_flow_preset("auto")


def test_upsample_mask_matches_jax_nearest():
    """The ambiguity mask's non-integer upsample ratios of the full-HD
    pyramid (34 -> 1080 rows, 60 -> 1920 columns)."""
    m = np.random.default_rng(1).uniform(size=(34, 60)) > 0.5
    ref = np.asarray(jdense._upsample_mask(jnp.asarray(m), (1080, 1920)))
    got = tdense._upsample_mask(torch.from_numpy(m), (1080, 1920)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("src,dst", [((17, 30), (34, 60)),
                                     ((34, 60), (68, 120)),
                                     ((68, 120), (135, 240))])
def test_bilinear_resize_matches_jax(src, dst):
    """jax.image.resize(bilinear) at the odd parent shapes of the pyramid
    (the feedback pass's upsample and the flow fallback)."""
    x = np.random.default_rng(3).normal(size=src).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), dst, "bilinear"))
    got = tdense._resize_bilinear(torch.from_numpy(x), dst).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)

