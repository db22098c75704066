"""2x2 mean downscale with edge-clamped borders (SSIMULACRA2 pyramid step).

Matches the canonical downscale (reference: ssimulacra2-cuda/examples/cpu.rs:545-579
and device kernel ssimulacra2-cuda-kernel/src/downscale.rs:5-35): output dims are
ceil(in/2); when a 2x2 window reads past the right/bottom edge the last
row/column is replicated; the four samples are summed in f32 then scaled by 1/4.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def downscale_by_2(x: jax.Array) -> jax.Array:
    """Downscale the last two axes by 2 (ceil), edge-replicated: a 2x2
    sum pool with stride 2 (reduce_window), then the 1/4 scale."""
    h, w = x.shape[-2], x.shape[-1]
    ph, pw = h % 2, w % 2
    if ph or pw:
        pad_cfg = [(0, 0)] * (x.ndim - 2) + [(0, ph), (0, pw)]
        x = jnp.pad(x, pad_cfg, mode="edge")
    window = (1,) * (x.ndim - 2) + (2, 2)
    pooled = jax.lax.reduce_window(x, 0.0, jax.lax.add, window, window, "VALID")
    return pooled * np.float32(0.25)


def scale_dims(h: int, w: int, num_scales: int = 6) -> list[tuple[int, int]]:
    """Pyramid dims actually computed, mirroring the reference loop guard
    (examples/cpu.rs:358-366): the `< 8` check applies to the dims *before*
    the scale's downscale, so a scale may be computed at dims below 8 (e.g.
    96x128 yields 5 scales, the last at 6x8)."""
    dims: list[tuple[int, int]] = []
    for s in range(num_scales):
        if h < 8 or w < 8:
            break
        if s:
            h, w = (h + 1) // 2, (w + 1) // 2
        dims.append((h, w))
    return dims
