"""The jnp device paths vs their NumPy oracles at odd and wide shapes.

Covers the shapes and formats the GPU runs: odd dimensions, wide frames,
8/10-bit, BT.709/BT.2020, PQ/HLG, limited/full range and full-chroma input.
"""

import functools

import jax
import numpy as np
import pytest

from tests.conftest import make_frame_pair
from turbo_metrics_tpu.models.ssimulacra2 import Ssimulacra2
from turbo_metrics_tpu.ops import quality
from turbo_metrics_tpu.ops.adm import adm_score, adm_stats
from turbo_metrics_tpu.ops.colorspace import yuv420_to_linear_rgb
from turbo_metrics_tpu.ops.vif import vif_scale_stats, vif_scores
from turbo_metrics_tpu.ops.vmaf_motion import integer_blur
from turbo_metrics_tpu.ops.xpsnr_ops import xpsnr_block_stats
from turbo_metrics_tpu.refimpl import adm as adm_oracle
from turbo_metrics_tpu.refimpl import colorspace as conv_oracle
from turbo_metrics_tpu.refimpl import quality as quality_oracle
from turbo_metrics_tpu.refimpl import ssimulacra2 as s2_oracle
from turbo_metrics_tpu.refimpl import vif as vif_oracle
from turbo_metrics_tpu.refimpl import vmaf_motion as motion_oracle
from turbo_metrics_tpu.refimpl import xpsnr as xpsnr_oracle


@pytest.mark.parametrize("hw", [(35, 61), (40, 130), (96, 129)])
def test_ssimulacra2_matches_fir_oracle(rng, hw):
    h, w = hw
    ref, dis = make_frame_pair(rng, h, w, noise=0.03)
    want = s2_oracle.compute_ssimulacra2(ref, dis, blur_impl="fir")
    got = Ssimulacra2(w, h).score_pair(ref, dis)
    assert got == pytest.approx(want, abs=0.01)


def _yuv(rng, h, w, depth, chroma):
    hi = (1 << depth) - 1
    ch = (h + 1) // 2 if chroma == 420 else h
    cw = w if chroma == 444 else (w + 1) // 2
    dt = np.uint8 if depth == 8 else np.uint16
    y = rng.integers(0, hi + 1, (h, w)).astype(dt)
    u = rng.integers(0, hi + 1, (ch, cw)).astype(dt)
    v = rng.integers(0, hi + 1, (ch, cw)).astype(dt)
    return y, u, v


def _check_conversion(rng, depth, matrix, transfer, full, chroma):
    h, w = 37, 61
    y, u, v = _yuv(rng, h, w, depth, chroma)
    fn = functools.partial(
        yuv420_to_linear_rgb, depth=depth, matrix=matrix, transfer=transfer,
        full_range=full, chroma=chroma,
    )
    got = np.asarray(jax.jit(fn)(y[None], np.stack([u, v], -1)[None]))[0]
    want = conv_oracle.yuv_to_linear_rgb(
        y, u, v, depth=depth, matrix=matrix, transfer=transfer,
        full_range=full, chroma=chroma,
    )
    assert got.shape == (3, h, w)
    # f32 powers vs f64: PQ's 1/m1 = 6.3 exponent reaches ~5e-5.
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("full", [False, True], ids=["limited", "full"])
@pytest.mark.parametrize("transfer", ["bt709", "pq", "hlg"])
@pytest.mark.parametrize("matrix", ["bt709", "bt2020"])
@pytest.mark.parametrize("depth", [8, 10])
def test_conversion_matches_oracle(rng, depth, matrix, transfer, full):
    _check_conversion(rng, depth, matrix, transfer, full, 420)


@pytest.mark.parametrize("chroma", [422, 444])
@pytest.mark.parametrize("depth", [8, 10])
def test_conversion_full_chroma_matches_oracle(rng, depth, chroma):
    _check_conversion(rng, depth, "bt709", "srgb", False, chroma)


def _code_pair(rng, h, w, noise):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    base = np.stack(
        [128 + 90 * np.sin(xx / (7 + 3 * k)) * np.cos(yy / (5 + 2 * k)) for k in range(3)]
    )
    a = np.round(np.clip(base + rng.normal(0, 2, base.shape), 0, 255))
    b = np.round(np.clip(a + rng.normal(0, noise, a.shape), 0, 255))
    return a, b


@pytest.mark.parametrize("hw", [(57, 83), (91, 117)])
def test_ssim_msssim_odd_dims_match_oracle(rng, hw):
    a, b = _code_pair(rng, *hw, noise=6.0)
    s, ms = jax.jit(quality.ssim_msssim)(
        a[None].astype(np.float32), b[None].astype(np.float32)
    )
    assert float(s[0]) == pytest.approx(quality_oracle.ssim(a, b), abs=2e-5)
    assert float(ms[0]) == pytest.approx(quality_oracle.msssim(a, b), abs=5e-5)


def _luma_pair(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ref = (128 + 70 * np.sin(xx / 11) * np.cos(yy / 7)).astype(np.float32)
    dis = np.clip(ref + rng.normal(0, 5, ref.shape), 0, 255).astype(np.float32)
    return np.round(ref), np.round(dis)


@pytest.mark.parametrize("hw", [(96, 1100), (161, 300)])
def test_vif_wide_matches_oracle(rng, hw):
    ref, dis = _luma_pair(rng, *hw)
    got = vif_scores(np.asarray(jax.jit(vif_scale_stats)(ref[None], dis[None])))
    want = vif_oracle.vif_frame(ref, dis)
    for k, v in want.items():
        assert float(got[k][0]) == pytest.approx(v, abs=1e-4), k


@pytest.mark.parametrize("hw", [(96, 1100), (161, 300)])
def test_adm_wide_matches_oracle(rng, hw):
    ref, dis = _luma_pair(rng, *hw)
    stats = np.asarray(jax.jit(adm_stats)(ref[None], dis[None]))
    got = adm_score(stats, *hw)
    want = adm_oracle.adm_frame(ref, dis)
    for k, v in want.items():
        assert float(got[k][0]) == pytest.approx(v, abs=2e-3), k


@pytest.mark.parametrize("hw", [(52, 70), (161, 300)])
def test_xpsnr_block_stats_10bit_bit_exact(rng, hw):
    h, w = hw
    ref, dis, prev = (
        rng.integers(0, 1024, (h, w), dtype=np.uint16) for _ in range(3)
    )
    stats = jax.jit(xpsnr_block_stats)(ref[None], dis[None], prev[None])
    r = ref.astype(np.int64)
    np.testing.assert_array_equal(
        np.asarray(stats["sse"])[0], xpsnr_oracle.block_sums((r - dis) ** 2)
    )
    np.testing.assert_array_equal(
        np.asarray(stats["sact"])[0],
        xpsnr_oracle.block_sums(xpsnr_oracle.highpass_abs(ref)),
    )
    np.testing.assert_array_equal(
        np.asarray(stats["tact"])[0], xpsnr_oracle.block_sums(np.abs(r - prev))
    )


@pytest.mark.parametrize("depth", [8, 10])
def test_motion_blur_and_sad_bit_exact(rng, depth):
    h, w = 33, 47
    frames = rng.integers(0, 1 << depth, (2, h, w)).astype(
        np.uint8 if depth == 8 else np.uint16
    )
    got = np.asarray(jax.jit(functools.partial(integer_blur, depth=depth))(frames))
    want = [motion_oracle.integer_blur(f, depth) for f in frames]
    np.testing.assert_array_equal(got, np.stack(want))
    _, sad = motion_oracle.motion_frame(frames[1], want[0], depth)
    assert int(np.abs(got[1].astype(np.int64) - got[0]).sum()) == sad
