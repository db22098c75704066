"""Integer (fixed-point) VIF device path — libvmaf's default-convention
analog, 32-bit schedule.

libvmaf's default VIF is fixed-point (``integer_vif.c``; the reference
binds libvmaf and reads these features back, vmaf/src/lib.rs:160-217).
This implements the exact schedule specified in
``refimpl/integer_vif.py`` (Q16/Q12 coefficient passes, defined rounding
shifts, integer moments, reflect-101 borders) with jnp integer ops:

* every blur accumulation has nonnegative terms and a true value < 2^32,
  so uint32 wraparound arithmetic reproduces the oracle's int64 result
  BIT-EXACTLY — no 64-bit integers needed (JAX's default is 32-bit);
* the moment statistics (s11/s22/s12, Q8) are int32-exact;
* only the final per-pixel log2 terms are float (f32 on device vs the
  oracle's f64 — gated at 1e-5 relative in tests; the integer statistics
  themselves are gated bit-exactly).

Opt-in via ``ops.vif.vif_scale_stats(..., integer=True)``.  This is a
fidelity mode, not a speed path; the float path is the default.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from turbo_metrics_tpu.ops.vif import NUM_SCALES

SIGMA_NSQ_Q8 = np.float32(512.0)


def _coeffs(scale: int, bits: int) -> np.ndarray:
    from turbo_metrics_tpu.refimpl.integer_vif import vif_coeffs_q

    return vif_coeffs_q(scale, bits)


def _corr_axis_q(x: jax.Array, c: np.ndarray, axis: int, rshift: int) -> jax.Array:
    """(sum_k c[k] * x + round) >> rshift along ``axis``; x uint32 with
    nonnegative true sums < 2^32 (wraparound-exact)."""
    n = len(c)
    r = n // 2
    dim = x.shape[axis]
    pad = [(0, 0)] * x.ndim
    pad[axis if axis >= 0 else x.ndim + axis] = (r, r)
    xp = jnp.pad(x, pad, mode="reflect")
    acc = jnp.zeros(x.shape, jnp.uint32)
    for k in range(n):
        acc = acc + jnp.uint32(int(c[k])) * jax.lax.slice_in_dim(
            xp, k, k + dim, axis=axis
        )
    return (acc + jnp.uint32(1 << (rshift - 1))) >> rshift


def integer_vif_scale_planes(
    ref: jax.Array, dis: jax.Array, *, depth: int = 8
) -> list[dict[str, jax.Array]]:
    """Per-scale integer statistic planes (int32; s* Q8, mu* Q4) — the
    bit-exact-vs-oracle surface.  Inputs: (..., H, W) integer luma."""
    x = ref.astype(jnp.uint32)
    y = dis.astype(jnp.uint32)
    if depth > 8:
        x = (x + jnp.uint32(1 << (depth - 9))) >> (depth - 8)
        y = (y + jnp.uint32(1 << (depth - 9))) >> (depth - 8)
    out = []
    for k in range(NUM_SCALES):
        c1 = _coeffs(k, 16)
        c2 = _coeffs(k, 12)
        if k > 0:
            xv = _corr_axis_q(x, c1, -2, 8)
            yv = _corr_axis_q(y, c1, -2, 8)
            x = _corr_axis_q(xv, c2, -1, 20)[..., ::2, ::2]
            y = _corr_axis_q(yv, c2, -1, 20)[..., ::2, ::2]
        xv = _corr_axis_q(x, c1, -2, 8)
        yv = _corr_axis_q(y, c1, -2, 8)
        mu1 = _corr_axis_q(xv, c2, -1, 16).astype(jnp.int32)
        mu2 = _corr_axis_q(yv, c2, -1, 16).astype(jnp.int32)
        pxx = _corr_axis_q(_corr_axis_q(x * x, c2, -2, 12), c2, -1, 4)
        pyy = _corr_axis_q(_corr_axis_q(y * y, c2, -2, 12), c2, -1, 4)
        pxy = _corr_axis_q(_corr_axis_q(x * y, c2, -2, 12), c2, -1, 4)
        s11 = jnp.maximum(pxx.astype(jnp.int32) - mu1 * mu1, 0)
        s22 = jnp.maximum(pyy.astype(jnp.int32) - mu2 * mu2, 0)
        s12 = pxy.astype(jnp.int32) - mu1 * mu2
        out.append(
            {
                "s11": s11,
                "s22": s22,
                "s12": s12,
                "mu1": mu1,
                "mu2": mu2,
                "ref": x.astype(jnp.int32),
                "dis": y.astype(jnp.int32),
            }
        )
    return out


def integer_vif_stats(
    ref: jax.Array, dis: jax.Array, *, depth: int = 8
) -> jax.Array:
    """Per-scale (num, den) sums under the integer conventions.

    (B, H, W) integer luma -> (B, 4, 2) f32 — same shape/meaning as the
    float ``vif_scale_stats`` so ``vif_scores`` applies unchanged."""
    planes = integer_vif_scale_planes(ref, dis, depth=depth)
    per_scale = []
    for p in planes:
        s11i, s22i, s12i = p["s11"], p["s22"], p["s12"]
        s11 = s11i.astype(jnp.float32)
        s22 = s22i.astype(jnp.float32)
        s12 = s12i.astype(jnp.float32)
        zero11 = s11i == 0
        zero22 = s22i == 0
        g = jnp.where(zero11, 0.0, s12 / jnp.where(zero11, 1.0, s11))
        sv = s22 - g * s12
        sv = jnp.where(zero11, s22, sv)
        s11c = jnp.where(zero11, 0.0, s11)
        sv = jnp.where(zero22, 0.0, sv)
        g = jnp.where(zero22, 0.0, g)
        sv = jnp.where(g < 0.0, s22, sv)
        g = jnp.maximum(g, 0.0)
        sv = jnp.maximum(sv, 1e-10)
        num = jnp.log2(1.0 + g * g * s11c / (sv + SIGMA_NSQ_Q8))
        den = jnp.log2(1.0 + s11c / SIGMA_NSQ_Q8)
        per_scale.append(
            jnp.stack([num.sum(axis=(-2, -1)), den.sum(axis=(-2, -1))], axis=-1)
        )
    return jnp.stack(per_scale, axis=-2)
