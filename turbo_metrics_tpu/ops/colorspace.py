"""Device colorspace conversions: YUV 4:2:0 / sRGB -> linear RGB, quantize.

Replacement for the reference's colorspace kernels
(cuda-colorspace-kernel/src/{lib.rs,biplanar.rs,srgb.rs,sample_conv.rs} and
the host dispatch in cuda-colorspace/src/lib.rs).  Everything is expressed as
vectorised jnp ops so XLA fuses the whole conversion into the downstream
metric program.

Conventions carried over from the reference:
  * YCbCr -> R'G'B' matrix coefficients are derived from the colour primaries
    (kr/kb via the XYZ route, cuda-colorspace-kernel/src/lib.rs:203-218), not
    from the rounded spec constants.
  * Luma is clamped below at the range minimum but *not* clamped above before
    the transfer function (biplanar.rs:47-53); the final linear value is
    clamped to [0, 1].
  * Chroma upsampling is nearest-neighbour (one chroma pair per 2x2 luma
    block, biplanar.rs:31-44).
  * The BT.709 "EOTF" is the inverse OETF (power 1/0.45 with linear toe),
    matching lib.rs:221-235.

Extensions over the reference (which `todo!()`s them): BT.2020 matrix, and
PQ (SMPTE 2084) / HLG transfers for the HDR/XPSNR path.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np


# --------------------------------------------------------------------------
# Matrix coefficients from primaries
# --------------------------------------------------------------------------

def _xy_to_xyz(x: float, y: float) -> np.ndarray:
    return np.array([x / y, 1.0, (1.0 - x - y) / y], dtype=np.float64)


def luma_coefficients(r, g, b, w) -> tuple[float, float]:
    """(kr, kb) derived from chromaticity primaries (f64).

    Same construction as the reference's const-eval
    (cuda-colorspace-kernel/src/lib.rs:203-218).
    """
    r_xyz, g_xyz, b_xyz, w_xyz = (_xy_to_xyz(*p) for p in (r, g, b, w))
    x_rgb = np.array([r_xyz[0], g_xyz[0], b_xyz[0]])
    y_rgb = np.array([r_xyz[1], g_xyz[1], b_xyz[1]])
    z_rgb = np.array([r_xyz[2], g_xyz[2], b_xyz[2]])
    mul = 1.0 / np.dot(x_rgb, np.cross(y_rgb, z_rgb))
    kr = np.dot(w_xyz, np.cross(g_xyz, b_xyz)) * mul
    kb = np.dot(w_xyz, np.cross(r_xyz, g_xyz)) * mul
    return float(kr), float(kb)


_D65 = (0.3127, 0.3290)
# Primaries tables (cuda-colorspace-kernel/src/constants.rs + H.273 for 2020).
PRIMARIES = {
    "bt709": ((0.640, 0.330), (0.300, 0.600), (0.150, 0.060), _D65),
    "bt601_525": ((0.630, 0.340), (0.310, 0.595), (0.155, 0.070), _D65),
    "bt601_625": ((0.640, 0.330), (0.290, 0.600), (0.150, 0.060), _D65),
    "bt2020": ((0.708, 0.292), (0.170, 0.797), (0.131, 0.046), _D65),
}

MATRIX_KR_KB = {name: luma_coefficients(*prims) for name, prims in PRIMARIES.items()}


# --------------------------------------------------------------------------
# Transfer functions (to linear)
# --------------------------------------------------------------------------

def bt709_eotf(v: jax.Array) -> jax.Array:
    """Inverse of the BT.709 OETF (cuda-colorspace-kernel/src/lib.rs:221-235)."""
    beta = np.float32(0.018053968510807)
    alpha = np.float32(1.0 + 5.5 * 0.018053968510807)
    threshold = np.float32(0.08124285829863521)
    lo = v / np.float32(4.5)
    hi = jnp.power(jnp.maximum((v + (alpha - 1.0)) / alpha, 0.0), np.float32(1.0 / 0.45))
    return jnp.where(v >= threshold, hi, lo)


def srgb_eotf(v: jax.Array) -> jax.Array:
    """sRGB inverse OETF (cuda-colorspace-kernel/src/srgb.rs:40-48)."""
    alpha = np.float32(1.0550107)
    beta = np.float32(0.0030412825)
    lo = v / np.float32(12.92)
    hi = jnp.power(jnp.maximum((v + (alpha - 1.0)) / alpha, 0.0), np.float32(2.4))
    return jnp.where(v < np.float32(12.92) * beta, lo, hi)


def pq_eotf(v: jax.Array, *, peak_nits: float = 10000.0, norm_nits: float = 10000.0) -> jax.Array:
    """SMPTE ST 2084 (PQ) EOTF, output normalised so ``norm_nits`` -> 1.0."""
    m1 = np.float32(2610.0 / 16384.0)
    m2 = np.float32(2523.0 / 4096.0 * 128.0)
    c1 = np.float32(3424.0 / 4096.0)
    c2 = np.float32(2413.0 / 4096.0 * 32.0)
    c3 = np.float32(2392.0 / 4096.0 * 32.0)
    # PQ is defined on [0, 1] code values; out-of-range excursions (limited
    # range + chroma overshoot) would drive the denominator negative.
    v = jnp.clip(v, 0.0, 1.0)
    p = jnp.power(v, np.float32(1.0) / m2)
    num = jnp.maximum(p - c1, 0.0)
    den = jnp.maximum(c2 - c3 * p, np.float32(1e-6))
    y = jnp.power(num / den, np.float32(1.0) / m1)  # in units of 10000 nits
    return y * np.float32(peak_nits / norm_nits)


def hlg_eotf(v: jax.Array) -> jax.Array:
    """HLG inverse OETF (scene-linear, normalised to [0, 1])."""
    a = np.float32(0.17883277)
    b = np.float32(1.0 - 4.0 * 0.17883277)
    c = np.float32(0.5 - 0.17883277 * np.log(4.0 * 0.17883277))
    lo = (v * v) / np.float32(3.0)
    hi = (jnp.exp((v - c) / a) + b) / np.float32(12.0)
    return jnp.where(v <= np.float32(0.5), lo, hi)


def identity_eotf(v: jax.Array) -> jax.Array:
    return v


TRANSFERS = {
    "bt709": bt709_eotf,
    "srgb": srgb_eotf,
    "pq": pq_eotf,
    "hlg": hlg_eotf,
    "linear": identity_eotf,
}


# --------------------------------------------------------------------------
# Range handling
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class SampleRange:
    """Code-value geometry for a given bit depth / signal range.

    Mirrors ColorRange in cuda-colorspace-kernel/src/lib.rs:42-169.
    """

    minimum: int
    luma_max: int
    chroma_max: int
    neutral: int

    @property
    def luma_range(self) -> int:
        return self.luma_max - self.minimum

    @property
    def chroma_range(self) -> int:
        return self.chroma_max - self.minimum


def sample_range(depth: int, full_range: bool) -> SampleRange:
    if full_range:
        return SampleRange(0, (1 << depth) - 1, (1 << depth) - 1, 1 << (depth - 1))
    shift = depth - 8
    return SampleRange(16 << shift, 235 << shift, 240 << shift, 1 << (depth - 1))


# --------------------------------------------------------------------------
# Conversions
# --------------------------------------------------------------------------

def yuv420_to_linear_rgb(
    y: jax.Array,
    uv: jax.Array,
    *,
    depth: int = 8,
    matrix: str = "bt709",
    transfer: str = "bt709",
    full_range: bool = False,
    chroma: int = 420,
) -> jax.Array:
    """Planar YCbCr -> linear RGB f32 in [0, 1].

    ``y``: (..., H, W) integer luma; ``uv``: (..., ch, cw, 2) chroma
    (Cb, Cr) at the ``chroma`` subsampling's grid — 420: (ceil(H/2),
    ceil(W/2)), 422: (H, ceil(W/2)), 444: (H, W).  Output: (..., 3, H, W)
    f32.

    Equivalent of biplanaryuv420_to_linearrgb_* in
    cuda-colorspace-kernel/src/biplanar.rs:8-70, extended to full-chroma
    4:2:2/4:4:4 input (the reference decimates everything to NVDEC's 4:2:0
    surfaces; this rebuild decodes on the host and keeps the real chroma
    grid).
    """
    kr, kb = MATRIX_KR_KB[matrix]
    rng = sample_range(depth, full_range)
    kg = 1.0 - kr - kb
    y_coeff = np.float32(1.0 / rng.luma_range)
    r_coeff = np.float32(2.0 * (1.0 - kr) / rng.chroma_range)
    b_coeff = np.float32(2.0 * (1.0 - kb) / rng.chroma_range)
    g_coeff1 = np.float32(-2.0 * (1.0 - kb) * kb / kg / rng.chroma_range)
    g_coeff2 = np.float32(-2.0 * (1.0 - kr) * kr / kg / rng.chroma_range)

    h, w = y.shape[-2], y.shape[-1]
    luma = (jnp.maximum(y.astype(jnp.float32), np.float32(rng.minimum))
            - np.float32(rng.minimum)) * y_coeff

    cb = uv[..., 0].astype(jnp.float32) - np.float32(rng.neutral)
    cr = uv[..., 1].astype(jnp.float32) - np.float32(rng.neutral)
    r_ = r_coeff * cr
    g_ = g_coeff1 * cb + g_coeff2 * cr
    b_ = b_coeff * cb
    # Nearest-neighbour chroma upsample onto the luma grid (420: one pair
    # per 2x2 luma block; 422: per 1x2 block; 444: already co-sited).
    def up(c):
        if chroma != 444:
            c = jnp.repeat(c, 2, axis=-1)
        if chroma == 420:
            c = jnp.repeat(c, 2, axis=-2)
        return c[..., :h, :w]

    eotf = TRANSFERS[transfer]
    chans = [up(r_), up(g_), up(b_)]
    rgb = jnp.stack([luma + c for c in chans], axis=-3)
    return jnp.clip(eotf(rgb), 0.0, 1.0)


def srgb_to_linear(x: jax.Array, *, depth: int | None = None) -> jax.Array:
    """Gamma sRGB -> linear f32.

    Integer inputs are normalised by (2^depth - 1) first (depth inferred from
    dtype when not given).  Matches srgb_to_linear_{u8,u16,f32}
    (cuda-colorspace-kernel/src/srgb.rs:50-127); the u8 LUT of the reference
    is just the formula tabulated, so the formula is used directly here.
    """
    if jnp.issubdtype(x.dtype, jnp.integer):
        if depth is None:
            depth = 8 if x.dtype == jnp.uint8 else 16
        x = x.astype(jnp.float32) / np.float32((1 << depth) - 1)
    return srgb_eotf(x)


def f32_to_uint8(x: jax.Array) -> jax.Array:
    """Quantize [0,1] f32 to u8 with round-to-nearest.

    Matches f32_to_8bit (cuda-colorspace-kernel/src/sample_conv.rs:5-35).
    """
    return jnp.clip(jnp.round(x * np.float32(255.0)), 0.0, 255.0).astype(jnp.uint8)
