"""The `auto` flow preset: rs_sfm_tpu_torch.flow.auto against the JAX
package's probe on the CPU, and `models.resolve_flow_preset`.

Two 64x96 pairs made in numpy from one seed: a smooth random texture and
its warp by a smooth sub-pixel flow ("clean"), and the same with frame 2
under a gain ramp ("photo").  The probe downsamples each once (it stops
below 64 pixels a side) and runs its 4-level flow on 32x48.  The JAX
statistics of both pairs come from one compiled function.

Tolerances: the occluded share within 1e-6 and the log-gain bias and
spread within 1e-5 (measured: the same occluded pixels, the shares 7e-9
apart by float32 rounding of the mean, bias and spread within 6.2e-7; the
port's SOR is the TPU kernel's absolute form, about 1e-3 px from the JAX
XLA loop, which on these pairs flips no pixel of the occlusion test); the
chosen preset equal, and the expected one (variational, robust).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax_reference import run_jitted

from rs_sfm_tpu.flow import auto as jauto
from rs_sfm_tpu.flow.dense import DenseFlowConfig as JaxFlowConfig
from rs_sfm_tpu_torch.flow import auto as tauto
from rs_sfm_tpu_torch.models import (FLOW_PRESETS, get_flow_preset,
                                     resolve_flow_preset)

# The test workers share the CPU with the JAX tests: a few intra-op threads
# each (the results do not depend on the count).
torch.set_num_threads(2)

H, W = 64, 96
STAT_TOL = {"occ_frac": 1e-6, "gain_bias": 1e-5, "gain_spread": 1e-5}
EXPECTED = {"clean": "variational", "photo": "robust"}


def _blur(x, passes=4):
    for _ in range(passes):
        x = (np.roll(x, 1, 0) + x + np.roll(x, -1, 0)) / 3.0
        x = (np.roll(x, 1, 1) + x + np.roll(x, -1, 1)) / 3.0
    return x


def _bilinear(img, fx, fy):
    h, w = img.shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    x = np.clip(xs + fx, 0, w - 1)
    y = np.clip(ys + fy, 0, h - 1)
    x0, y0 = np.floor(x).astype(int), np.floor(y).astype(int)
    x1, y1 = np.minimum(x0 + 1, w - 1), np.minimum(y0 + 1, h - 1)
    ax, ay = x - x0, y - y0
    return ((1 - ay) * ((1 - ax) * img[y0, x0] + ax * img[y0, x1])
            + ay * ((1 - ax) * img[y1, x0] + ax * img[y1, x1]))


def _pairs(seed=11):
    """{"clean": (i1, i2), "photo": (i1, i2)} float32 RGB frames in [0, 1]."""
    rng = np.random.default_rng(seed)
    tex = _blur(rng.uniform(size=(H, W)), 2) + 0.5 * _blur(
        rng.uniform(size=(H, W)), 6)
    tex = (tex - tex.min()) / (tex.max() - tex.min()) * 0.8 + 0.1
    ys, xs = np.mgrid[0:H, 0:W] / np.array([H, W])[:, None, None]
    fx = 1.3 + 0.6 * xs - 0.4 * ys
    fy = -0.7 + 0.3 * ys
    i1 = tex
    i2 = _bilinear(tex, -fx, -fy)
    gain = 0.75 + 0.2 * xs
    rgb = lambda g: np.repeat(g[..., None], 3, -1).astype(np.float32)  # noqa
    return {"clean": (rgb(i1), rgb(i2)),
            "photo": (rgb(i1), rgb(np.clip(i2 * gain, 0.0, 1.0)))}


@pytest.fixture(scope="module")
def probes():
    """(pairs, the JAX statistics of both pairs from one compiled function:
    `_probe_stats` on each pair downsampled once, as the JAX
    `probe_flow_preset` does)."""
    pairs = _pairs()
    cfg = JaxFlowConfig(levels=4, iters=12, warps=2)

    def both(*frames):
        out = []
        for a, b in zip(frames[0::2], frames[1::2]):
            g1, g2 = jauto._to_gray(a), jauto._to_gray(b)
            g1, g2 = jauto._downsample(g1), jauto._downsample(g2)
            out.append(jauto._probe_stats(g1, g2, cfg))
        return out

    frames = [jnp.asarray(f) for name in EXPECTED for f in pairs[name]]
    stats = run_jitted(both, *frames)
    return pairs, {name: dict(zip(STAT_TOL, (float(x) for x in s)))
                   for name, s in zip(EXPECTED, stats)}


def _jax_choice(s):
    robust = (s["gain_spread"] > jauto.GAIN_SPREAD_THRESHOLD
              or s["gain_bias"] > jauto.GAIN_BIAS_THRESHOLD)
    return "robust" if robust else "variational"


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_probe_matches_jax(probes, name):
    pairs, want = probes
    i1, i2 = (torch.from_numpy(f) for f in pairs[name])
    got_name, got = tauto.probe_flow_preset(i1, i2, return_stats=True)
    for key, tol in STAT_TOL.items():
        assert abs(got[key] - want[name][key]) <= tol, (key, got, want)
    assert got_name == _jax_choice(want[name]) == EXPECTED[name]


def test_probe_thresholds_are_the_jax_ones():
    assert tauto.OCC_THRESHOLD is jauto.OCC_THRESHOLD is None
    assert tauto.GAIN_SPREAD_THRESHOLD == jauto.GAIN_SPREAD_THRESHOLD
    assert tauto.GAIN_BIAS_THRESHOLD == jauto.GAIN_BIAS_THRESHOLD
    assert tauto.PROBE_CONFIG._asdict() == JaxFlowConfig(
        levels=4, iters=12, warps=2)._asdict()


def test_identical_frames_have_no_gain():
    """A frame against itself: no pixel occluded and a zero log-gain
    field, so the bias and the spread vanish."""
    i1 = torch.rand(20, 24, generator=torch.Generator().manual_seed(0))
    occ, bias, spread = tauto._probe_stats(i1, i1)
    assert float(occ) == 0.0
    assert float(bias) < 1e-6 and abs(float(spread)) < 1e-6


def test_resolve_flow_preset(probes):
    pairs, _ = probes
    cfg, name = resolve_flow_preset(
        "auto", *(torch.from_numpy(f) for f in pairs["photo"]),
        warp_engine="pallas")
    assert name == "robust"
    assert cfg == FLOW_PRESETS["robust"]._replace(warp_engine="pallas")
    assert resolve_flow_preset("fast") == (FLOW_PRESETS["fast"], "fast")
    with pytest.raises(ValueError, match="frame pair"):
        resolve_flow_preset("auto")
    with pytest.raises(KeyError, match="resolve_flow_preset"):
        get_flow_preset("auto")


def test_probe_needs_a_card_for_numpy_input(probes, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pairs, _ = probes
    with pytest.raises(RuntimeError, match="CUDA"):
        tauto.probe_flow_preset(*pairs["clean"])
