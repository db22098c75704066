"""Classic quality metrics: PSNR, SSIM, MS-SSIM on 8-bit-quantized RGB.

Replacement for the NPP statistics primitives the reference calls
(nppiPSNR/nppiSSIM/nppiWMSSSIM via cudarse-npp/src/image/ist.rs:68-181, driven
from turbo-metrics/src/lib.rs:296-339).  Like the reference, these operate on
linear-RGB frames quantized to 8 bits (turbo-metrics/src/lib.rs:296-305);
inputs here are f32 arrays holding code values in [0, 255] with layout
(..., 3, H, W).

NPP's kernels are closed source; these implement the canonical published
definitions (Wang et al. 2004 SSIM with an 11x11 sigma=1.5 Gaussian window on
the valid region; Wang et al. 2003 MS-SSIM with the standard 5 scale weights),
which is what NPP documents itself as computing.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from turbo_metrics_tpu.ops.gaussian import gaussian_window

_K1 = 0.01
_K2 = 0.03
_L = 255.0
_C1 = np.float32((_K1 * _L) ** 2)
_C2 = np.float32((_K2 * _L) ** 2)

MSSSIM_WEIGHTS = np.array([0.0448, 0.2856, 0.3001, 0.2363, 0.1333], dtype=np.float64)


def psnr(a: jax.Array, b: jax.Array, *, peak: float = 255.0) -> jax.Array:
    """PSNR in dB over all channels; reduces all but leading batch dims.

    a, b: (..., C, H, W).  Returns (...,).
    """
    diff = a - b
    mse = jnp.mean(diff * diff, axis=(-3, -2, -1))
    return np.float32(10.0) * jnp.log10(np.float32(peak * peak) / mse)


def _filter_valid(x: jax.Array, win: np.ndarray) -> jax.Array:
    """Separable 'valid' correlation with a 1D window over the last two axes."""
    n = len(win)
    w = [jnp.asarray(v, dtype=x.dtype) for v in win.astype(np.float32)]
    wdim = x.shape[-1] - n + 1
    x = sum(w[k] * jax.lax.slice_in_dim(x, k, k + wdim, axis=-1) for k in range(n))
    hdim = x.shape[-2] - n + 1
    x = sum(w[k] * jax.lax.slice_in_dim(x, k, k + hdim, axis=-2) for k in range(n))
    return x


def _ssim_parts(a: jax.Array, b: jax.Array):
    win = gaussian_window(11, 1.5)
    mu1 = _filter_valid(a, win)
    mu2 = _filter_valid(b, win)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s11 = _filter_valid(a * a, win) - mu1_sq
    s22 = _filter_valid(b * b, win) - mu2_sq
    s12 = _filter_valid(a * b, win) - mu12
    luminance = (2.0 * mu12 + _C1) / (mu1_sq + mu2_sq + _C1)
    cs = (2.0 * s12 + _C2) / (s11 + s22 + _C2)
    return luminance, cs


def _level_means(a: jax.Array, b: jax.Array):
    """(mean(luminance*cs), mean(cs)) over (C, valid H, valid W) -> (...,)."""
    luminance, cs = _ssim_parts(a, b)
    return (
        jnp.mean(luminance * cs, axis=(-3, -2, -1)),
        jnp.mean(cs, axis=(-3, -2, -1)),
    )


def ssim(a: jax.Array, b: jax.Array) -> jax.Array:
    """Mean SSIM index; (..., C, H, W) -> (...,)."""
    return _level_means(a, b)[0]


def _downsample_2x2(x: jax.Array) -> jax.Array:
    """2x2 average pool with stride 2, truncating odd edges (MS-SSIM step)."""
    h, w = x.shape[-2] & ~1, x.shape[-1] & ~1
    x = x[..., :h, :w]
    x = x.reshape(*x.shape[:-2], h // 2, 2, w // 2, 2)
    return x.mean(axis=(-3, -1))


def _clamp_levels(h: int, w: int, levels: int):
    """Clamp MS-SSIM levels so the 11x11 window still fits after
    downsampling (min dim >= 11 * 2^(levels-1)); renormalise the clamped
    weights to sum 1."""
    fit = max(1, (min(h, w) // 11).bit_length())
    levels = min(levels, fit)
    weights = MSSSIM_WEIGHTS[:levels]
    if levels < len(MSSSIM_WEIGHTS):
        weights = weights / weights.sum()
    return levels, weights


def _msssim_levels(a: jax.Array, b: jax.Array, levels: int):
    """Per-level (mean(luminance*cs), mean(cs)) plus the clamped weights.

    Level 0's ml IS the single-scale SSIM index — the shared substrate
    for :func:`msssim` and :func:`ssim_msssim`.
    """
    levels, weights = _clamp_levels(a.shape[-2], a.shape[-1], levels)
    per_level = []
    for lvl in range(levels):
        per_level.append(_level_means(a, b))
        if lvl < levels - 1:
            a = _downsample_2x2(a)
            b = _downsample_2x2(b)
    return per_level, weights


def _msssim_combine(per_level, weights) -> jax.Array:
    levels = len(per_level)
    result = None
    for lvl, (ml, mcs) in enumerate(per_level):
        base = ml if lvl == levels - 1 else mcs
        term = jnp.power(jnp.maximum(base, 0.0), np.float32(weights[lvl]))
        result = term if result is None else result * term
    return result


def msssim(a: jax.Array, b: jax.Array, *, levels: int = 5) -> jax.Array:
    """Multi-scale SSIM (Wang 2003); (..., C, H, W) -> (...,)."""
    return _msssim_combine(*_msssim_levels(a, b, levels))


def ssim_msssim(
    a: jax.Array, b: jax.Array, *, levels: int = 5
) -> tuple[jax.Array, jax.Array]:
    """(SSIM, MS-SSIM) sharing one level-0 windowed pass.

    MS-SSIM's level 0 computes exactly the windowed stats SSIM needs, so
    requesting both metrics separately would compute the most expensive
    level twice.  Values match ``ssim(a, b)`` / ``msssim(a, b)`` computed
    independently.
    """
    per_level, weights = _msssim_levels(a, b, levels)
    return per_level[0][0], _msssim_combine(per_level, weights)
