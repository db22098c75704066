"""VIF (Visual Information Fidelity) elementary features, float pipeline.

The remaining big VMAF elementary feature after motion (the reference's
vmaf-cuda never got past motion; libvmaf computes VIF at 4 scales:
vif_scale0..3).  This is the classic pixel-domain VIF used by VMAF:

  per scale k in 0..3:
    window: Gaussian, N = 2^(4-k) + 1 taps, sigma = N/5
    k > 0: ref/dis <- decimate2(blur_N(ref/dis))   [the CURRENT scale's
           window, as in the classic vifp_mscale.m and libvmaf's vif.c]
    mu1, mu2       = blur_N(ref), blur_N(dis)
    sigma1_sq      = blur_N(ref^2)  - mu1^2   (clamped >= 0)
    sigma2_sq      = blur_N(dis^2)  - mu2^2   (clamped >= 0)
    sigma12        = blur_N(ref*dis) - mu1*mu2
    g              = sigma12 / (sigma1_sq + eps), guarded
    sv_sq          = sigma2_sq - g * sigma12, guarded
    num           += log2(1 + g^2 * sigma1_sq / (sv_sq + sigma_nsq))
    den           += log2(1 + sigma1_sq / sigma_nsq)
    vif_scale_k    = num / den

with sigma_nsq = 2, eps = 1e-10, reflect-101 borders (libvmaf's
vif_filter1d mirroring: ind < 0 -> -ind, ind >= n -> 2n-ind-2).
Inputs are luma code values normalised to the 8-bit range.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

SIGMA_NSQ = np.float32(2.0)
EPS = np.float32(1e-10)
NUM_SCALES = 4


def vif_window(scale: int) -> np.ndarray:
    """Gaussian window for a VIF scale: N = 2^(4-k)+1 taps, sigma = N/5 (f64)."""
    n = (1 << (4 - scale)) + 1
    sigma = n / 5.0
    half = (n - 1) / 2.0
    g = np.exp(-((np.arange(n) - half) ** 2) / (2.0 * sigma**2))
    return (g / g.sum()).astype(np.float64)


def _blur_same(x: jax.Array, win: np.ndarray) -> jax.Array:
    """Separable 'same' correlation with reflect-101 (mirror) borders."""
    n = len(win)
    r = n // 2
    w = [jnp.float32(v) for v in win]
    h_dim, w_dim = x.shape[-2], x.shape[-1]
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 2) + [(0, 0), (r, r)], mode="reflect")
    x = sum(w[k] * jax.lax.slice_in_dim(xp, k, k + w_dim, axis=-1) for k in range(n))
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 2) + [(r, r), (0, 0)], mode="reflect")
    x = sum(w[k] * jax.lax.slice_in_dim(xp, k, k + h_dim, axis=-2) for k in range(n))
    return x


def _decimate2(x: jax.Array) -> jax.Array:
    return x[..., ::2, ::2]


def vif_scale_stats(
    ref: jax.Array, dis: jax.Array, *, integer: bool = False, depth: int = 8,
) -> jax.Array:
    """Per-scale (num, den) sums for (B, H, W) f32 luma in 8-bit units.

    Returns (B, 4, 2): [..., k, 0] = num_k, [..., k, 1] = den_k.

    ``integer=True`` selects the fixed-point path matching libvmaf's
    default integer-VIF conventions (ops/integer_vif.py; inputs are then
    integer code values at ``depth`` bits) — an opt-in fidelity mode,
    bit-exact at the statistics level vs refimpl/integer_vif.py.
    """
    if integer:
        from turbo_metrics_tpu.ops.integer_vif import integer_vif_stats

        return integer_vif_stats(ref, dis, depth=depth)
    out = []
    for k in range(NUM_SCALES):
        win = vif_window(k)
        if k > 0:
            ref = _decimate2(_blur_same(ref, win))
            dis = _decimate2(_blur_same(dis, win))
        mu1 = _blur_same(ref, win)
        mu2 = _blur_same(dis, win)
        s11 = jnp.maximum(_blur_same(ref * ref, win) - mu1 * mu1, 0.0)
        s22 = jnp.maximum(_blur_same(dis * dis, win) - mu2 * mu2, 0.0)
        s12 = _blur_same(ref * dis, win) - mu1 * mu2

        g = s12 / (s11 + EPS)
        sv_sq = s22 - g * s12
        # Guards (order matters, mirroring the classic implementation).
        g = jnp.where(s11 < EPS, 0.0, g)
        sv_sq = jnp.where(s11 < EPS, s22, sv_sq)
        s11c = jnp.where(s11 < EPS, 0.0, s11)
        sv_sq = jnp.where(s22 < EPS, 0.0, sv_sq)
        g = jnp.where(s22 < EPS, 0.0, g)
        sv_sq = jnp.where(g < 0.0, s22, sv_sq)
        g = jnp.maximum(g, 0.0)
        sv_sq = jnp.maximum(sv_sq, EPS)

        num = jnp.log2(1.0 + g * g * s11c / (sv_sq + SIGMA_NSQ))
        den = jnp.log2(1.0 + s11c / SIGMA_NSQ)
        out.append(
            jnp.stack(
                [num.sum(axis=(-2, -1)), den.sum(axis=(-2, -1))], axis=-1
            )
        )
    return jnp.stack(out, axis=-2)  # (B, 4, 2)


def vif_scores(stats: np.ndarray) -> dict[str, np.ndarray]:
    """(..., 4, 2) sums -> per-scale scores + overall VIF."""
    stats = np.asarray(stats, dtype=np.float64)
    num = stats[..., 0]
    den = stats[..., 1]
    per_scale = num / np.maximum(den, 1e-30)
    overall = num.sum(axis=-1) / np.maximum(den.sum(axis=-1), 1e-30)
    return {
        **{f"vif_scale{k}": per_scale[..., k] for k in range(NUM_SCALES)},
        "vif": overall,
    }
