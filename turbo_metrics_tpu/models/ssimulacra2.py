"""SSIMULACRA2 engine — the flagship metric, as one jitted XLA program.

A redesign of the reference's CUDA-graph engine
(ssimulacra2-cuda/src/lib.rs:27-447): where the reference records ~305 kernel
launches into a CUDA graph and replays it per frame, here the whole 6-scale
pyramid — XYB conversion, products, separable FIR Gaussian blurs, error maps
and norm reductions — is a single traced jnp program that XLA fuses and
schedules.  Frames are processed in batches so the device stays saturated;
the final 108-weight dot product and nonlinearity run on the host in f64
(models/ssimulacra2_score.py).

Layout: (B, 3, H, W) planar f32 — planar keeps the pixel rows contiguous and
avoids the interleaved-RGB layout the reference itself lists as a perf
regret (ssimulacra2-cuda/README.md "How to do better?").
"""

from __future__ import annotations

import functools
import jax
import jax.numpy as jnp
import numpy as np

from turbo_metrics_tpu.ops.downscale import downscale_by_2, scale_dims
from turbo_metrics_tpu.ops.gaussian import blur_2d
from turbo_metrics_tpu.ops.ssim_maps import scale_norms
from turbo_metrics_tpu.ops.xyb import linear_rgb_to_xyb
from turbo_metrics_tpu.models.ssimulacra2_score import postprocess_score

NUM_SCALES = 6

BACKENDS = ("jnp", "jnp_iir")


def ssimulacra2_subscores(
    lin_ref: jax.Array,
    lin_dis: jax.Array,
    *,
    num_scales: int,
    backend: str = "jnp",
) -> jax.Array:
    """Sub-scores for a batch of linear-RGB frame pairs.

    Inputs: (B, 3, H, W) f32 linear RGB in [0, 1].
    Output: (B, 3, num_scales, 2, 3) f32 — (channel, scale, norm, map).

    The scale loop is unrolled at trace time (static shapes per scale), so
    XLA sees one static program — the analog of the reference's CUDA graph
    capture (ssimulacra2-cuda/src/lib.rs:140-229).

    ``backend``: 'jnp' blurs with the 11-tap FIR (ops/gaussian.blur_2d);
    'jnp_iir' is the parity mode — the faithful f32 recursive Gaussian the
    canonical CPU implementations use, with their rounding drift
    (ops/gaussian.blur_2d_iir), ~10x slower.
    """
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown SSIMULACRA2 backend {backend!r}; expected one of {BACKENDS}"
        )
    blur_fn = blur_2d
    if backend == "jnp_iir":
        from turbo_metrics_tpu.ops.gaussian import blur_2d_iir

        blur_fn = blur_2d_iir

    per_scale = []
    for s in range(num_scales):
        if s:
            lin_ref = downscale_by_2(lin_ref)
            lin_dis = downscale_by_2(lin_dis)
        xyb1 = linear_rgb_to_xyb(lin_ref)
        xyb2 = linear_rgb_to_xyb(lin_dis)
        # Blur 5 quantities (mu1, mu2, sigma11, sigma22, sigma12) in one
        # fused separable pass — the analog of the reference's 5-image
        # fused blur launch (ssimulacra2-cuda/src/kernel.rs:219-277).
        stacked = jnp.concatenate(
            [xyb1, xyb2, xyb1 * xyb1, xyb2 * xyb2, xyb1 * xyb2], axis=1
        )
        mu1, mu2, s11, s22, s12 = jnp.split(blur_fn(stacked), 5, axis=1)
        per_scale.append(scale_norms(xyb1, xyb2, mu1, mu2, s11, s22, s12))
    return jnp.stack(per_scale, axis=2)


class Ssimulacra2:
    """Per-resolution SSIMULACRA2 scorer (mirrors Ssimulacra2 in
    ssimulacra2-cuda/src/lib.rs:27-45, redesigned for batched XLA dispatch).

    The jitted program is compiled once per (batch, height, width) and reused
    for every frame pair — memory is O(1) in video length.
    """

    def __init__(
        self, width: int, height: int, *, batch: int = 1, backend: str = "jnp"
    ):
        self.width = int(width)
        self.height = int(height)
        self.batch = int(batch)
        self.dims = scale_dims(self.height, self.width, NUM_SCALES)
        self.num_scales = len(self.dims)
        self._fn = jax.jit(
            functools.partial(
                ssimulacra2_subscores,
                num_scales=self.num_scales,
                backend=backend,
            )
        )

    def subscores_device(self, lin_ref: jax.Array, lin_dis: jax.Array) -> jax.Array:
        """Device-side sub-scores; inputs (B, 3, H, W) f32."""
        if self.num_scales == 0:
            raise ValueError("image must be at least 8x8")
        return self._fn(lin_ref, lin_dis)

    def score_batch(self, lin_ref, lin_dis) -> np.ndarray:
        """Scores for a batch of frame pairs -> (B,) f64 numpy array."""
        vals = np.asarray(self.subscores_device(lin_ref, lin_dis), dtype=np.float64)
        return postprocess_score(vals)

    def score_pair(self, lin_ref, lin_dis) -> float:
        """Score a single (3, H, W) or (H, W, 3) linear-RGB pair."""
        lin_ref = _to_planar_batch(lin_ref)
        lin_dis = _to_planar_batch(lin_dis)
        return float(self.score_batch(lin_ref, lin_dis)[0])


def _to_planar_batch(img) -> jnp.ndarray:
    img = jnp.asarray(img, dtype=jnp.float32)
    if img.ndim == 3 and img.shape[-1] == 3 and img.shape[0] != 3:
        img = jnp.transpose(img, (2, 0, 1))
    if img.ndim == 3:
        img = img[None]
    return img
