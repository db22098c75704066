"""VMAF motion feature: integer 5-tap blur + SAD against the previous frame.

Equivalent of the reference's motion kernel
(vmaf-cuda-kernel/src/integer_motion.rs:28-92), bit-exact integer math:

    blurred_y(col)  = sum_k F[k] * sample           (u32)
    tmp             = (blurred_y + 2^(N-1)) >> N
    blurred         = (sum_k F[k] * tmp + 32768) >> 16   (u16)
    sad             = sum |blurred - prev_blurred|

with the reference's asymmetric mirroring (reflect on the low edge,
symmetric on the high edge — integer_motion.rs:18-25).  The motion score is
SAD normalised per pixel, matching libvmaf's "motion" elementary feature.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

FILTER = np.array([3571, 16004, 26386, 16004, 3571], dtype=np.uint32)
RADIUS = 2


def _pad_mirror(x: jax.Array, axis: int) -> jax.Array:
    """Pad RADIUS on both sides: low edge 'reflect', high edge 'symmetric'."""
    n = x.shape[axis]
    lo = jax.lax.slice_in_dim(x, 1, RADIUS + 1, axis=axis)
    lo = jnp.flip(lo, axis=axis)
    hi = jax.lax.slice_in_dim(x, n - RADIUS, n, axis=axis)
    hi = jnp.flip(hi, axis=axis)
    return jnp.concatenate([lo, x, hi], axis=axis)


def integer_blur(y: jax.Array, *, depth: int = 8) -> jax.Array:
    """Exact-integer separable 5-tap blur of (..., H, W) luma -> uint16."""
    x = y.astype(jnp.uint32)
    h, w = y.shape[-2], y.shape[-1]

    # Vertical pass (over rows), then horizontal, as in the kernel.
    xp = _pad_mirror(x, axis=-2)
    acc = jnp.zeros_like(x)
    for k in range(5):
        acc = acc + FILTER[k] * jax.lax.slice_in_dim(xp, k, k + h, axis=-2)
    tmp = (acc + jnp.uint32(1 << (depth - 1))) >> depth

    tp = _pad_mirror(tmp, axis=-1)
    acc2 = jnp.zeros_like(tmp)
    for k in range(5):
        acc2 = acc2 + FILTER[k] * jax.lax.slice_in_dim(tp, k, k + w, axis=-1)
    return ((acc2 + jnp.uint32(32768)) >> 16).astype(jnp.uint16)


def motion_score(sad: int, width: int, height: int, *, depth: int = 8) -> float:
    """SAD -> libvmaf 'motion' score: mean abs diff in 8-bit units.

    The integer blur outputs samples scaled to the 16-bit range regardless of
    source depth (the >>N / >>16 shifts normalise exactly), so the SAD is
    divided by 2^(16-8) = 256 to express motion in 8-bit code values.
    """
    del depth  # blur output scale is depth-independent
    return float(sad) / (width * height) / 256.0
