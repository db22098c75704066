"""SSIMULACRA2 device pipeline vs the faithful CPU oracle."""

import numpy as np
import pytest

from tests.conftest import make_frame_pair

import jax.numpy as jnp

from turbo_metrics_tpu.models.ssimulacra2 import Ssimulacra2
from turbo_metrics_tpu.ops.downscale import downscale_by_2, scale_dims
from turbo_metrics_tpu.ops.gaussian import blur_2d, gaussian_taps
from turbo_metrics_tpu.ops.xyb import linear_rgb_to_xyb
from turbo_metrics_tpu.refimpl import ssimulacra2 as oracle


def test_gaussian_taps_match_recurrence(rng):
    """The 11-tap FIR must equal the reference recursive filter."""
    taps = gaussian_taps()
    assert taps.shape == (11,)
    assert np.allclose(taps, taps[::-1], atol=1e-6)  # symmetric (up to tail)
    assert abs(taps.sum() - 1.0) < 1e-4  # ~normalised Gaussian

    plane = rng.random((24, 37), dtype=np.float64).astype(np.float32)
    got = np.asarray(blur_2d(jnp.asarray(plane)))
    want = oracle.blur(plane)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_downscale_matches_oracle(rng):
    img = rng.random((33, 41, 3), dtype=np.float64).astype(np.float32)
    want = oracle.downscale_by_2(img)  # (17, 21, 3)
    got = np.asarray(downscale_by_2(jnp.asarray(img.transpose(2, 0, 1))))
    np.testing.assert_allclose(got.transpose(1, 2, 0), want, atol=1e-6)


def test_xyb_matches_oracle(rng):
    img = rng.random((16, 24, 3), dtype=np.float64).astype(np.float32)
    want = oracle.linear_to_xyb(img)
    got = np.asarray(linear_rgb_to_xyb(jnp.asarray(img.transpose(2, 0, 1))))
    # cbrt differs by a few ULPs between XLA and NumPy.
    np.testing.assert_allclose(got.transpose(1, 2, 0), want, atol=1e-5)


def test_scale_dims():
    assert scale_dims(1080, 1920) == [
        (1080, 1920),
        (540, 960),
        (270, 480),
        (135, 240),
        (68, 120),
        (34, 60),
    ]
    # The <8 guard applies pre-downscale: 8x8 still gets a 4x4 scale.
    assert scale_dims(8, 8) == [(8, 8), (4, 4)]
    assert scale_dims(96, 128) == [(96, 128), (48, 64), (24, 32), (12, 16), (6, 8)]
    assert scale_dims(7, 100) == []


def test_identical_images_score_100(rng):
    ref, _ = make_frame_pair(rng, 64, 80)
    engine = Ssimulacra2(80, 64)
    score = engine.score_pair(ref, ref)
    assert score == pytest.approx(100.0, abs=1e-3)


@pytest.mark.parametrize("hw,noise", [((96, 128), 0.02), ((67, 83), 0.05)])
def test_score_matches_oracle(rng, hw, noise):
    h, w = hw
    ref, dis = make_frame_pair(rng, h, w, noise=noise)
    want = oracle.compute_ssimulacra2(ref, dis)
    engine = Ssimulacra2(w, h)
    got = engine.score_pair(ref, dis)
    # Parity budget is +/-0.05 vs the CPU reference; we expect far tighter.
    assert got == pytest.approx(want, abs=0.02)
    assert 0.0 < want < 100.0


def test_batched_scores_match_single(rng):
    h, w = 48, 64
    pairs = [make_frame_pair(rng, h, w, noise=n) for n in (0.01, 0.04, 0.1)]
    engine = Ssimulacra2(w, h)
    ref = np.stack([p[0].transpose(2, 0, 1) for p in pairs])
    dis = np.stack([p[1].transpose(2, 0, 1) for p in pairs])
    batch_scores = engine.score_batch(jnp.asarray(ref), jnp.asarray(dis))
    for i, (r, d) in enumerate(pairs):
        single = engine.score_pair(r, d)
        assert batch_scores[i] == pytest.approx(single, abs=1e-6)
    # more noise => lower score
    assert batch_scores[0] > batch_scores[1] > batch_scores[2]


def test_iir_backend_matches_iir_oracle(rng):
    """The device f32-IIR blur mode tracks the faithful reference recursion
    far tighter than the FIR path does (VERDICT r1: +/-0.05 vs the IIR
    oracle; the FIR-vs-IIR gap is ~0.13 at SD+)."""
    h, w = 96, 128
    ref, dis = make_frame_pair(rng, h, w, noise=0.04)
    want_iir = oracle.compute_ssimulacra2(ref, dis, blur_impl="iir")
    engine = Ssimulacra2(w, h, backend="jnp_iir")
    got = engine.score_pair(ref, dis)
    assert got == pytest.approx(want_iir, abs=0.01)


def test_iir_blur_matches_oracle_blur(rng):
    """blur_2d_iir reproduces the reference recursion plane-for-plane."""
    from turbo_metrics_tpu.ops.gaussian import blur_2d_iir
    from turbo_metrics_tpu.refimpl.ssimulacra2 import blur as oracle_blur

    x = rng.random((37, 53)).astype(np.float32)
    want = oracle_blur(x)
    got = np.asarray(blur_2d_iir(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)  # f32 FMA-order noise


def test_golden_score_frozen():
    """Golden-score regression anchored to the reference's sample-pair
    methodology (ssimulacra2-cuda/examples/compare.rs:70-95: one fixed image
    pair, CPU reference value, tolerance gate).  The canonical C scorer is
    not available in this environment, so the anchor is this repo's f64
    NumPy oracle on a frozen procedural pair — the value below must never
    drift (oracle gate 1e-4), and the device pipeline must stay within the
    BASELINE.md +/-0.05 budget of it (the reference's own GPU gate was
    +/-0.25)."""
    from turbo_metrics_tpu.refimpl.ssimulacra2 import srgb8_to_linear

    rng = np.random.default_rng(20240901)
    h, w = 120, 160
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack(
        [
            128 + 90 * np.sin(xx / 13.0) * np.cos(yy / 11.0),
            128 + 70 * np.cos(xx / 7.0),
            128 + 50 * np.sin((xx + yy) / 19.0),
        ],
        axis=-1,
    )
    ref8 = np.clip(base, 0, 255).astype(np.uint8)
    dis8 = np.clip(
        ref8.astype(np.int16) + rng.integers(-9, 10, ref8.shape), 0, 255
    ).astype(np.uint8)
    lin_ref = srgb8_to_linear(ref8)
    lin_dis = srgb8_to_linear(dis8)

    GOLDEN = 80.486135  # f64 NumPy oracle (FIR blur), frozen 2026-08-16
    got_oracle = oracle.compute_ssimulacra2(lin_ref, lin_dis, blur_impl="fir")
    assert got_oracle == pytest.approx(GOLDEN, abs=1e-4)

    engine = Ssimulacra2(w, h)
    got_device = engine.score_pair(lin_ref, lin_dis)
    assert got_device == pytest.approx(GOLDEN, abs=0.05)


def test_score_monotone_in_distortion(rng):
    """Published invariant: more distortion, lower score (used as an
    algorithm-level sanity anchor; docs/VALIDATION.md)."""
    from turbo_metrics_tpu.models.ssimulacra2 import Ssimulacra2

    h, w = 64, 96
    base = rng.random((3, h, w), dtype=np.float64).astype(np.float32) * 0.6 + 0.2
    s2 = Ssimulacra2(w, h)
    scores = []
    for sigma in (0.0, 0.01, 0.04, 0.12):
        noise = rng.normal(0, sigma, base.shape).astype(np.float32)
        dis = np.clip(base + noise, 0, 1)
        scores.append(s2.score_pair(base, dis))
    assert scores[0] == 100.0
    assert all(a > b for a, b in zip(scores, scores[1:]))


@pytest.mark.parametrize(
    "backend", ["pallas", "pallas3", "interpret", "interpret3", "auto"]
)
def test_removed_backend_names_raise(backend):
    from turbo_metrics_tpu.models.ssimulacra2 import ssimulacra2_subscores

    x = jnp.zeros((1, 3, 16, 16), jnp.float32)
    with pytest.raises(ValueError, match="unknown SSIMULACRA2 backend"):
        ssimulacra2_subscores(x, x, num_scales=2, backend=backend)
