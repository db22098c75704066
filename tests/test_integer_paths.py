"""Integer (fixed-point) VIF/ADM paths vs their NumPy integer oracles.

The integer stages (filtered statistics, DWT bands, decoupling angle gate)
must match BIT-EXACTLY — the schedules are specified in
refimpl/integer_vif.py / refimpl/integer_adm.py precisely so the 32-bit
device arithmetic reproduces the int64 oracle without any tolerance.  The
float finishes (log2 / CSF / pooling) are gated at tolerance.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from turbo_metrics_tpu.ops.adm import adm_score, adm_stats
from turbo_metrics_tpu.ops.integer_adm import integer_adm_levels
from turbo_metrics_tpu.ops.integer_vif import integer_vif_scale_planes
from turbo_metrics_tpu.ops.vif import vif_scale_stats, vif_scores
from turbo_metrics_tpu.refimpl.integer_adm import (
    integer_adm_frame,
    integer_adm_levels as oracle_adm_levels,
)
from turbo_metrics_tpu.refimpl.integer_vif import (
    integer_vif_frame,
    integer_vif_planes,
)


def _pair(h, w, seed=0, depth=8):
    rng = np.random.default_rng(seed)
    hi = (1 << depth) - 1
    yy, xx = np.mgrid[0:h, 0:w]
    base = ((hi + 1) // 2 + (hi // 4) * np.sin(xx / 13.0) * np.cos(yy / 7.0))
    ref = np.clip(base + rng.normal(0, hi / 64, (h, w)), 0, hi)
    dis = np.clip(ref + rng.normal(0, hi / 32, (h, w)), 0, hi)
    dt = np.uint8 if depth == 8 else np.uint16
    return ref.astype(dt), dis.astype(dt)


# -- integer VIF ------------------------------------------------------------


@pytest.mark.parametrize("hw", [(72, 96), (81, 107)])
def test_integer_vif_planes_bitexact(hw):
    ref, dis = _pair(*hw, seed=1)
    dev = jax.jit(integer_vif_scale_planes)(ref, dis)
    ora = integer_vif_planes(ref, dis)
    for k, (d, o) in enumerate(zip(dev, ora)):
        for key in ("s11", "s22", "s12", "mu1", "mu2", "ref", "dis"):
            np.testing.assert_array_equal(
                np.asarray(d[key]), o[key], err_msg=f"scale {k} {key}"
            )


def test_integer_vif_planes_bitexact_extremes():
    """Worst-case ranges: flat 0/255 and a 0-255 checkerboard (maximum
    variance) must not overflow the 32-bit device schedule."""
    h, w = 64, 80
    yy, xx = np.mgrid[0:h, 0:w]
    checker = (((yy + xx) % 2) * 255).astype(np.uint8)
    for ref, dis in [
        (np.zeros((h, w), np.uint8), np.full((h, w), 255, np.uint8)),
        (checker, 255 - checker),
        (np.full((h, w), 255, np.uint8), np.full((h, w), 255, np.uint8)),
    ]:
        dev = jax.jit(integer_vif_scale_planes)(ref, dis)
        ora = integer_vif_planes(ref, dis)
        for d, o in zip(dev, ora):
            for key in ("s11", "s22", "s12", "mu1", "mu2"):
                np.testing.assert_array_equal(np.asarray(d[key]), o[key])


def test_integer_vif_stats_match_oracle_scores():
    ref, dis = _pair(96, 128, seed=2)
    stats = np.asarray(
        jax.jit(lambda a, b: vif_scale_stats(a, b, integer=True))(ref, dis)
    )
    got = vif_scores(stats[None])
    want = integer_vif_frame(ref, dis)
    for k in ("vif_scale0", "vif_scale1", "vif_scale2", "vif_scale3", "vif"):
        assert got[k][0] == pytest.approx(want[k], rel=2e-5, abs=2e-5), k


def test_integer_vif_close_to_float_path():
    """Sanity: the integer conventions agree with the float path to a few
    e-3 of VIF score on natural-ish content (they are the same metric at
    different arithmetic)."""
    ref, dis = _pair(96, 128, seed=3)
    int_stats = np.asarray(vif_scale_stats(ref, dis, integer=True))
    flt_stats = np.asarray(
        vif_scale_stats(
            ref.astype(np.float32), dis.astype(np.float32)
        )
    )
    vi = vif_scores(int_stats[None])["vif"][0]
    vf = vif_scores(flt_stats[None])["vif"][0]
    assert abs(vi - vf) < 5e-3, (vi, vf)


def test_integer_vif_depth10():
    ref, dis = _pair(64, 96, seed=4, depth=10)
    dev = jax.jit(
        lambda a, b: integer_vif_scale_planes(a, b, depth=10)
    )(ref, dis)
    ora = integer_vif_planes(ref, dis, depth=10)
    for d, o in zip(dev, ora):
        np.testing.assert_array_equal(np.asarray(d["s12"]), o["s12"])


def test_integer_vif_batched():
    r0, d0 = _pair(64, 80, seed=5)
    r1, d1 = _pair(64, 80, seed=6)
    stats = np.asarray(
        vif_scale_stats(np.stack([r0, r1]), np.stack([d0, d1]), integer=True)
    )
    s0 = np.asarray(vif_scale_stats(r0[None], d0[None], integer=True))
    np.testing.assert_allclose(stats[0], s0[0], rtol=1e-6)


# -- integer ADM ------------------------------------------------------------


@pytest.mark.parametrize("hw", [(72, 96), (81, 107)])
def test_integer_adm_levels_bitexact(hw):
    ref, dis = _pair(*hw, seed=7)
    dev = jax.jit(integer_adm_levels)(ref, dis)
    ora = oracle_adm_levels(ref, dis)
    for li, (d, o) in enumerate(zip(dev, ora)):
        for key in ("o_h", "o_v", "o_d", "t_h", "t_v", "t_d", "angle_ok"):
            np.testing.assert_array_equal(
                np.asarray(d[key]), o[key], err_msg=f"level {li} {key}"
            )


def test_integer_adm_levels_bitexact_extremes():
    h, w = 64, 80
    yy, xx = np.mgrid[0:h, 0:w]
    checker = (((yy + xx) % 2) * 255).astype(np.uint8)
    for ref, dis in [
        (checker, 255 - checker),
        (np.zeros((h, w), np.uint8), np.full((h, w), 255, np.uint8)),
    ]:
        dev = jax.jit(integer_adm_levels)(ref, dis)
        ora = oracle_adm_levels(ref, dis)
        for d, o in zip(dev, ora):
            for key in ("o_h", "o_v", "o_d", "t_h", "t_v", "t_d"):
                np.testing.assert_array_equal(np.asarray(d[key]), o[key])


def test_integer_adm_stats_match_oracle_scores():
    ref, dis = _pair(96, 128, seed=8)
    stats = np.asarray(
        jax.jit(lambda a, b: adm_stats(a, b, integer=True))(
            ref[None], dis[None]
        )
    )[0]
    got = {k: float(v) for k, v in adm_score(stats, 96, 128).items()}
    want = integer_adm_frame(ref, dis)
    for k in ("adm2", "adm_scale0", "adm_scale1", "adm_scale2", "adm_scale3"):
        assert got[k] == pytest.approx(want[k], rel=5e-4, abs=5e-4), k


def test_integer_adm_close_to_float_path():
    ref, dis = _pair(96, 128, seed=9)
    int_stats = np.asarray(adm_stats(ref[None], dis[None], integer=True))[0]
    flt_stats = np.asarray(
        adm_stats(
            ref[None].astype(np.float32),
            dis[None].astype(np.float32),
        )
    )[0]
    ai = float(adm_score(int_stats, 96, 128)["adm2"])
    af = float(adm_score(flt_stats, 96, 128)["adm2"])
    assert abs(ai - af) < 2e-2, (ai, af)


def test_engine_vmaf_integer_matches_oracle():
    """TurboMetrics(vmaf_integer=True) routes VIF/ADM through the integer
    paths: per-frame features must match the integer refimpl oracles."""
    from turbo_metrics_tpu.color.characteristics import ColorCharacteristics
    from turbo_metrics_tpu.engine import Metrics, TurboMetrics
    from turbo_metrics_tpu.io.frame_source import RawFrame

    h, w = 96, 128
    rng = np.random.default_rng(11)
    refs, diss = [], []
    for i in range(2):
        y, yd = _pair(h, w, seed=20 + i)
        uv = rng.integers(100, 156, (h // 2, w // 2, 2), dtype=np.uint8)
        refs.append(RawFrame(y=y, uv=uv, depth=8, full_range=False))
        diss.append(RawFrame(y=yd, uv=uv, depth=8, full_range=False))
    cc = (ColorCharacteristics.from_code_points(1, 1, 1), "limited")
    eng = TurboMetrics(w, h, Metrics(vmaf=True), batch=2, vmaf_integer=True)
    scores = eng.compute_frames(refs, cc, diss, cc)
    for i, s in enumerate(scores):
        want_v = integer_vif_frame(refs[i].y, diss[i].y)
        want_a = integer_adm_frame(refs[i].y, diss[i].y)
        assert s.vmaf_vif == pytest.approx(want_v["vif"], rel=2e-5, abs=2e-5)
        assert s.vmaf_adm == pytest.approx(want_a["adm2"], rel=5e-4, abs=5e-4)
