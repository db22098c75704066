"""NumPy f64 reference for planar YCbCr -> linear RGB — the conversion oracle.

An independent per-sample formulation of the published equations, used to
check ops/colorspace.yuv420_to_linear_rgb.  It follows the conventions the
reference's colorspace kernels define (cuda-colorspace-kernel/src/lib.rs,
biplanar.rs, srgb.rs), which the device path shares:

  * kr/kb come from the colour primaries, here by solving the RGB->XYZ
    white-point system (the device uses the equivalent cross-product form);
  * luma is clamped below at the range minimum but not above, before the
    transfer function; the final linear value is clamped to [0, 1];
  * chroma is upsampled nearest-neighbour onto the luma grid;
  * the BT.709 "EOTF" is the inverse OETF (power 1/0.45 with linear toe).
"""

from __future__ import annotations

import numpy as np

from turbo_metrics_tpu.ops.colorspace import PRIMARIES


def luma_weights(matrix: str) -> tuple[float, float]:
    """(kr, kb): the Y row of the RGB->XYZ matrix whose white maps to Y=1."""
    cols = []
    for x, y in PRIMARIES[matrix]:
        cols.append([x / y, 1.0, (1.0 - x - y) / y])
    m = np.array(cols[:3], dtype=np.float64).T  # columns: R, G, B in XYZ
    white = np.array(cols[3], dtype=np.float64)
    s = np.linalg.solve(m, white)  # per-primary luminance scale
    kr, _, kb = m[1] * s
    return float(kr), float(kb)


def _inverse_oetf(v: np.ndarray, transfer: str) -> np.ndarray:
    if transfer == "bt709":
        beta = 0.018053968510807
        alpha = 1.0 + 5.5 * beta
        hi = np.maximum((v + alpha - 1.0) / alpha, 0.0) ** (1.0 / 0.45)
        return np.where(v >= 4.5 * beta, hi, v / 4.5)
    if transfer == "srgb":
        alpha, beta = 1.0550107, 0.0030412825
        hi = np.maximum((v + alpha - 1.0) / alpha, 0.0) ** 2.4
        return np.where(v < 12.92 * beta, v / 12.92, hi)
    if transfer == "pq":  # SMPTE ST 2084, 10000 nits -> 1.0
        m1, m2 = 2610.0 / 16384.0, 2523.0 / 4096.0 * 128.0
        c1, c2, c3 = 3424.0 / 4096.0, 2413.0 / 4096.0 * 32.0, 2392.0 / 4096.0 * 32.0
        p = np.clip(v, 0.0, 1.0) ** (1.0 / m2)
        return (np.maximum(p - c1, 0.0) / (c2 - c3 * p)) ** (1.0 / m1)
    if transfer == "hlg":  # ARIB STD-B67 inverse OETF, scene light in [0, 1]
        a = 0.17883277
        b = 1.0 - 4.0 * a
        c = 0.5 - a * np.log(4.0 * a)
        return np.where(v <= 0.5, v * v / 3.0, (np.exp((v - c) / a) + b) / 12.0)
    if transfer == "linear":
        return v
    raise ValueError(f"unknown transfer {transfer!r}")


def yuv_to_linear_rgb(
    y: np.ndarray,
    u: np.ndarray,
    v: np.ndarray,
    *,
    depth: int = 8,
    matrix: str = "bt709",
    transfer: str = "bt709",
    full_range: bool = False,
    chroma: int = 420,
) -> np.ndarray:
    """(H, W) luma + (ch, cw) Cb/Cr code values -> (3, H, W) f64 linear RGB."""
    h, w = y.shape
    if full_range:
        lo, luma_hi, chroma_hi = 0, (1 << depth) - 1, (1 << depth) - 1
    else:
        lo, luma_hi, chroma_hi = 16 << (depth - 8), 235 << (depth - 8), 240 << (depth - 8)
    neutral = 1 << (depth - 1)
    kr, kb = luma_weights(matrix)
    kg = 1.0 - kr - kb

    rows = np.arange(h) // (2 if chroma == 420 else 1)
    cols = np.arange(w) // (1 if chroma == 444 else 2)
    cb = (u.astype(np.float64) - neutral)[np.ix_(rows, cols)] / (chroma_hi - lo)
    cr = (v.astype(np.float64) - neutral)[np.ix_(rows, cols)] / (chroma_hi - lo)
    luma = (np.maximum(y.astype(np.float64), lo) - lo) / (luma_hi - lo)
    r = luma + 2.0 * (1.0 - kr) * cr
    g = luma - 2.0 * (1.0 - kb) * kb / kg * cb - 2.0 * (1.0 - kr) * kr / kg * cr
    b = luma + 2.0 * (1.0 - kb) * cb
    return np.clip(_inverse_oetf(np.stack([r, g, b]), transfer), 0.0, 1.0)
