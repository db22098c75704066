"""SSIMULACRA2 per-scale error maps and norm reductions.

Implements the modified-SSIM map and the edge-difference (artifact /
detail-loss) maps with their 1-norm and 4-norm reductions, following the
canonical math (reference: ssimulacra2-cuda/examples/cpu.rs:581-683, device
kernel ssimulacra2-cuda-kernel/src/error_maps.rs:5-60).

Numerics:
  * Everything is f32; XLA reductions are tree-structured so the f32 mean is
    accurate to ~1e-6 relative even at 4K (the reference accumulates in f64
    on a scalar CPU loop — tree reduction achieves the same accuracy).
  * The edge-diff ratio is computed as (a - b) / (1 + b) instead of
    (1 + a) / (1 + b) - 1 — mathematically identical but avoids the f32
    catastrophic cancellation of the literal form.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

C2 = np.float32(0.0009)


def scale_norms(
    img1: jax.Array,
    img2: jax.Array,
    mu1: jax.Array,
    mu2: jax.Array,
    s11: jax.Array,
    s22: jax.Array,
    s12: jax.Array,
) -> jax.Array:
    """Per-scale reductions over (..., C, H, W) inputs.

    ``img1``/``img2`` are the XYB planes, ``mu*`` their blurs, ``s11``/``s22``/
    ``s12`` the blurred products blur(img1*img1) etc.

    Returns an array of shape (..., C, 2, 3): axis -2 is the norm (0 = 1-norm,
    1 = 4-norm), axis -1 is the map (0 = ssim, 1 = artifact, 2 = detail-loss).
    This ordering matches the flat weight indexing of the final score
    (examples/cpu.rs:843-854).
    """
    one = np.float32(1.0)

    # Modified SSIM map (cpu.rs:604-631): d = max(0, 1 - num_m*num_s/denom_s).
    mu12 = mu1 * mu2
    mu_diff = mu1 - mu2
    num_m = one - mu_diff * mu_diff
    num_s = np.float32(2.0) * (s12 - mu12) + C2
    denom_s = (s11 - mu1 * mu1) + (s22 - mu2 * mu2) + C2
    # 1 - num_m*num_s/denom_s, written as a single quotient: identical
    # algebraically, but exact (d == 0) for identical inputs where the
    # literal form leaves FMA-rounding residuals that the score weights
    # would amplify.
    d = jnp.maximum((denom_s - num_m * num_s) / denom_s, 0.0)

    # Edge-difference map (cpu.rs:651-674):
    #   d1 = (1 + |img2 - mu2|) / (1 + |img1 - mu1|) - 1, rewritten stably.
    a = jnp.abs(img2 - mu2)
    b = jnp.abs(img1 - mu1)
    d1 = (a - b) / (one + b)
    artifact = jnp.maximum(d1, 0.0)
    detail_lost = jnp.maximum(-d1, 0.0)

    def norms(m):
        n1 = jnp.mean(m, axis=(-2, -1))
        m2 = m * m
        n4 = jnp.sqrt(jnp.sqrt(jnp.mean(m2 * m2, axis=(-2, -1))))
        return jnp.stack([n1, n4], axis=-1)  # (..., C, 2)

    return jnp.stack([norms(d), norms(artifact), norms(detail_lost)], axis=-1)
