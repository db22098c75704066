"""Faithful NumPy CPU reference for SSIMULACRA 2.1 — the test oracle.

This mirrors the canonical scalar implementation that the reference project
gates its GPU results against (ssimulacra2-cuda/examples/cpu.rs, itself a port
of rust-av/ssimulacra2 / cloudinary ssimulacra2): f32 per-pixel math, the
actual recursive-Gaussian recurrence (not the FIR equivalent the device path
uses), and f64 accumulation in the map reductions.  It is intentionally slow
and simple; the pytest suite asserts the JAX pipeline matches it to well
under the +/-0.05 parity budget.
"""

from __future__ import annotations

import numpy as np

from turbo_metrics_tpu.models.ssimulacra2_score import postprocess_score

NUM_SCALES = 6
C2 = np.float32(0.0009)

_MUL_IN = np.float32([0.055295236, -0.058836687, 0.012955819])
_MUL_PREV = np.float32([1.9021131, 1.1755705, 1.2246469e-16])
_RADIUS = 5


def srgb8_to_linear(img: np.ndarray) -> np.ndarray:
    """u8 sRGB -> linear f32, identical to the reference 256-entry LUT."""
    lut = np.empty(256, dtype=np.float32)
    v = np.arange(256, dtype=np.float64) / 255.0
    alpha, beta = 1.0550107, 0.0030412825
    lo = v / 12.92
    hi = ((v + (alpha - 1.0)) / alpha) ** 2.4
    lut[:] = np.where(v < 12.92 * beta, lo, hi).astype(np.float32)
    return lut[img]


def _blur_pass(x: np.ndarray) -> np.ndarray:
    """One recursive-Gaussian pass along axis 0 of a 2D f32 array."""
    length, lanes = x.shape
    out = np.zeros_like(x)
    prev = np.zeros((3, lanes), dtype=np.float32)
    prev2 = np.zeros((3, lanes), dtype=np.float32)
    zero = np.zeros(lanes, dtype=np.float32)
    for n in range(-_RADIUS + 1, length):
        left = n - _RADIUS - 1
        right = n + _RADIUS - 1
        s = (x[left] if left >= 0 else zero) + (x[right] if 0 <= right < length else zero)
        cur = s[None, :] * _MUL_IN[:, None] + _MUL_PREV[:, None] * prev - prev2
        prev2, prev = prev, cur
        if n >= 0:
            out[n] = cur.sum(axis=0, dtype=np.float32)
    return out


def blur(plane: np.ndarray) -> np.ndarray:
    """Recursive-Gaussian blur of a 2D f32 plane (horizontal then vertical)."""
    tmp = _blur_pass(plane.T.copy()).T  # horizontal pass
    return _blur_pass(tmp)  # vertical pass


def blur_fir(plane: np.ndarray) -> np.ndarray:
    """The same filter as an exact 11-tap FIR (see ops/gaussian.py).

    In exact arithmetic this equals the recursive form; in f32 the recursive
    form carries an undamped rounding drift (the oscillator's poles sit on
    the unit circle) that this formulation does not.  The device pipeline
    uses this formulation; ``compute_ssimulacra2(..., blur_impl="fir")``
    isolates that difference when checking parity.
    """
    from turbo_metrics_tpu.ops.gaussian import gaussian_taps

    taps = gaussian_taps().astype(np.float32)
    h, w = plane.shape
    p = np.pad(plane, _RADIUS).astype(np.float32)
    t = np.zeros((h + 2 * _RADIUS, w), np.float32)
    for k in range(11):
        t += taps[k] * p[:, k : k + w]
    out = np.zeros((h, w), np.float32)
    for k in range(11):
        out += taps[k] * t[k : k + h, :]
    return out


def downscale_by_2(img: np.ndarray) -> np.ndarray:
    """(H, W, C) -> (ceil(H/2), ceil(W/2), C), edge-clamped 2x2 mean, f32."""
    h, w, c = img.shape
    ph, pw = h % 2, w % 2
    if ph or pw:
        img = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="edge")
    oh, ow = (h + 1) // 2, (w + 1) // 2
    out = img.reshape(oh, 2, ow, 2, c).sum(axis=(1, 3), dtype=np.float32)
    return out * np.float32(0.25)


def linear_to_xyb(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) linear RGB -> positive-shifted XYB, f32."""
    m02, m00 = np.float32(0.078), np.float32(0.30)
    m01 = np.float32(1.0) - m02 - m00
    m12, m10 = np.float32(0.078), np.float32(0.23)
    m11 = np.float32(1.0) - m12 - m10
    m20, m21 = np.float32(0.24342269), np.float32(0.20476745)
    m22 = np.float32(1.0) - m20 - m21
    bias = np.float32(0.0037930734)
    root = np.float32(0.15595420255272392)

    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    rmix = m00 * r + m01 * g + m02 * b + bias
    gmix = m10 * r + m11 * g + m12 * b + bias
    bmix = m20 * r + m21 * g + m22 * b + bias
    rg = np.cbrt(np.maximum(rmix, np.float32(0.0))) - root
    gr = np.cbrt(np.maximum(gmix, np.float32(0.0))) - root
    bb = np.cbrt(np.maximum(bmix, np.float32(0.0))) - root
    x = np.float32(0.5) * (rg - gr)
    y = np.float32(0.5) * (rg + gr)
    return np.stack(
        [x * np.float32(14.0) + np.float32(0.42),
         y + np.float32(0.01),
         bb - y + np.float32(0.55)],
        axis=-1,
    ).astype(np.float32)


def _ssim_map(mu1, mu2, s11, s22, s12) -> np.ndarray:
    """Per-channel (1-norm, 4-norm) of the modified SSIM error map, f64 acc."""
    out = np.zeros((3, 2), dtype=np.float64)
    npx = mu1.shape[0] * mu1.shape[1]
    for c in range(3):
        m1, m2 = mu1[..., c], mu2[..., c]
        num_m = np.float32(1.0) - (m1 - m2) * (m1 - m2)
        num_s = np.float32(2.0) * (s12[..., c] - m1 * m2) + C2
        denom = (s11[..., c] - m1 * m1) + (s22[..., c] - m2 * m2) + C2
        d = 1.0 - ((num_m * num_s) / denom).astype(np.float64)
        d = np.maximum(d, 0.0)
        out[c, 0] = d.sum() / npx
        out[c, 1] = ((d**4).sum() / npx) ** 0.25
    return out


def _edge_diff_map(img1, mu1, img2, mu2) -> np.ndarray:
    """Per-channel (art1, art4, det1, det4), f64 accumulation."""
    out = np.zeros((3, 4), dtype=np.float64)
    npx = img1.shape[0] * img1.shape[1]
    for c in range(3):
        d1 = (1.0 + np.abs(img2[..., c] - mu2[..., c]).astype(np.float64)) / (
            1.0 + np.abs(img1[..., c] - mu1[..., c]).astype(np.float64)
        ) - 1.0
        artifact = np.maximum(d1, 0.0)
        detail = np.maximum(-d1, 0.0)
        out[c, 0] = artifact.sum() / npx
        out[c, 1] = ((artifact**4).sum() / npx) ** 0.25
        out[c, 2] = detail.sum() / npx
        out[c, 3] = ((detail**4).sum() / npx) ** 0.25
    return out


def compute_ssimulacra2(
    ref_linear: np.ndarray, dis_linear: np.ndarray, *, blur_impl: str = "iir"
) -> float:
    """SSIMULACRA2 score for one pair of (H, W, 3) linear-RGB f32 images.

    ``blur_impl``: "iir" is the faithful reference recursion (f32, with its
    characteristic rounding drift); "fir" is the mathematically-equal exact
    filter the device uses.  The two differ by up to ~0.15 on the score at
    SD+ resolutions — the same f32-ordering spread behind the reference
    project's own +/-0.25 GPU-vs-CPU gate (compare.rs:70-74).
    """
    blur_plane = blur if blur_impl == "iir" else blur_fir
    img1 = np.asarray(ref_linear, dtype=np.float32)
    img2 = np.asarray(dis_linear, dtype=np.float32)
    assert img1.shape == img2.shape and img1.ndim == 3 and img1.shape[2] == 3

    per_scale = []  # (3, 2, 3): channel, norm, map
    for scale in range(NUM_SCALES):
        h, w = img1.shape[:2]
        if h < 8 or w < 8:
            break
        if scale > 0:
            img1 = downscale_by_2(img1)
            img2 = downscale_by_2(img2)
        xyb1 = linear_to_xyb(img1)
        xyb2 = linear_to_xyb(img2)

        def blur3(img):
            return np.stack([blur_plane(img[..., c]) for c in range(3)], axis=-1)

        mu1 = blur3(xyb1)
        mu2 = blur3(xyb2)
        s11 = blur3(xyb1 * xyb1)
        s22 = blur3(xyb2 * xyb2)
        s12 = blur3(xyb1 * xyb2)

        avg_ssim = _ssim_map(mu1, mu2, s11, s22, s12)  # (3, 2)
        avg_edge = _edge_diff_map(xyb1, mu1, xyb2, mu2)  # (3, 4)
        # Assemble (3, 2, 3): [norm n][map: ssim, artifact, detail].
        scale_vals = np.zeros((3, 2, 3), dtype=np.float64)
        for n in range(2):
            scale_vals[:, n, 0] = avg_ssim[:, n]
            scale_vals[:, n, 1] = avg_edge[:, n]
            scale_vals[:, n, 2] = avg_edge[:, n + 2]
        per_scale.append(scale_vals)

    if not per_scale:
        return 100.0
    vals = np.stack(per_scale, axis=1)  # (3, S, 2, 3)
    return float(postprocess_score(vals))
