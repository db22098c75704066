"""Linear RGB -> positive-shifted XYB, the perceptual colorspace of SSIMULACRA2.

Math follows the canonical implementation (reference:
ssimulacra2-cuda/examples/cpu.rs:421-469 and the device kernel
ssimulacra2-cuda-kernel/src/xyb.rs:42-102): the JPEG XL opsin absorbance
matrix with bias, cube root, opponent recombination, then the affine shift
that brings every component into roughly [0, 1]:

    X' = 14 * X + 0.42,  Y' = Y + 0.01,  B' = (B - Y) + 0.55

All per-pixel math is f32, as in the reference.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Opsin constants; derived rows sum to 1 in f32 (cpu.rs:421-436).
_K_M02 = np.float32(0.078)
_K_M00 = np.float32(0.30)
_K_M01 = np.float32(1.0) - _K_M02 - _K_M00
_K_M12 = np.float32(0.078)
_K_M10 = np.float32(0.23)
_K_M11 = np.float32(1.0) - _K_M12 - _K_M10
_K_M20 = np.float32(0.24342269)
_K_M21 = np.float32(0.20476745)
_K_M22 = np.float32(1.0) - _K_M20 - _K_M21

OPSIN_ABSORBANCE_MATRIX = np.array(
    [
        [_K_M00, _K_M01, _K_M02],
        [_K_M10, _K_M11, _K_M12],
        [_K_M20, _K_M21, _K_M22],
    ],
    dtype=np.float32,
)
OPSIN_ABSORBANCE_BIAS = np.float32(0.0037930734)
OPSIN_ABSORBANCE_BIAS_ROOT = np.float32(0.15595420255272392)


def linear_rgb_to_xyb(rgb: jax.Array, *, channel_axis: int = -3) -> jax.Array:
    """Convert linear RGB to positive-shifted XYB.

    ``rgb``: float32 array with a 3-channel axis (default layout (..., 3, H, W)).
    Returns the same layout with channels (X', Y', B').
    """
    r = jax.lax.index_in_dim(rgb, 0, axis=channel_axis, keepdims=False)
    g = jax.lax.index_in_dim(rgb, 1, axis=channel_axis, keepdims=False)
    b = jax.lax.index_in_dim(rgb, 2, axis=channel_axis, keepdims=False)

    m = OPSIN_ABSORBANCE_MATRIX
    bias = OPSIN_ABSORBANCE_BIAS
    rmix = m[0, 0] * r + m[0, 1] * g + m[0, 2] * b + bias
    gmix = m[1, 0] * r + m[1, 1] * g + m[1, 2] * b + bias
    bmix = m[2, 0] * r + m[2, 1] * g + m[2, 2] * b + bias

    root = OPSIN_ABSORBANCE_BIAS_ROOT
    # The mixes are >= the opsin bias > 0.  XLA's f32 cbrt is within 1.15 ulp
    # of the f64 root on the H100 (1.19 on the CPU) over the whole input
    # range, so no refinement step is needed.
    rg = jnp.cbrt(rmix) - root
    gr = jnp.cbrt(gmix) - root
    bb = jnp.cbrt(bmix) - root

    x = 0.5 * (rg - gr)
    y = 0.5 * (rg + gr)
    # Positive shift folded in, exactly as cpu.rs:468 (B' uses unshifted Y).
    out = [x * np.float32(14.0) + np.float32(0.42),
           y + np.float32(0.01),
           bb - y + np.float32(0.55)]
    return jnp.stack(out, axis=channel_axis)
