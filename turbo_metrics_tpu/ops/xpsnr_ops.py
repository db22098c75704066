"""XPSNR device ops: per-block SSE, spatial and temporal activity.

Equivalent of xpsnr_support_8/xpsnr_postprocess
(xpsnr-cuda-kernel/src/lib.rs:38-120) and the NPP highpass filter setup
(xpsnr-cuda/src/lib.rs:92-115).  The warp-shuffle + atomic per-block
accumulation of the CUDA kernel becomes a reshape into (16, 16) tiles and a
tile-sum — one fused XLA reduction.

Border note: the reference filters with NPP over the full ROI, which reads
out of bounds at the borders (undefined).  Here the highpass uses
edge-replicated padding (defined, and matching FFmpeg's XPSNR behaviour).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

BLOCK = 16

# 3x3 highpass, xpsnr-cuda/src/lib.rs:67.
HIGHPASS = np.array([[-1, -2, -1], [-2, 12, -2], [-1, -2, -1]], dtype=np.int32)


def highpass_3x3(y: jax.Array) -> jax.Array:
    """|highpass| of an integer luma plane (..., H, W) -> int32 magnitudes."""
    x = y.astype(jnp.int32)
    p = jnp.pad(x, [(0, 0)] * (x.ndim - 2) + [(1, 1), (1, 1)], mode="edge")
    h, w = y.shape[-2], y.shape[-1]
    acc = jnp.zeros_like(x)
    for dy in range(3):
        for dx in range(3):
            c = int(HIGHPASS[dy, dx])
            acc = acc + c * jax.lax.slice_in_dim(
                jax.lax.slice_in_dim(p, dy, dy + h, axis=-2), dx, dx + w, axis=-1
            )
    return jnp.abs(acc)


def block_sums(x: jax.Array, block: int = BLOCK) -> jax.Array:
    """Sum (..., H, W) over block x block tiles -> (..., ceil(H/b), ceil(W/b)).

    Edge tiles are zero-padded, so partial blocks sum only their valid pixels
    (same as the reference's bounds check, kernel lib.rs:65-67).
    """
    h, w = x.shape[-2], x.shape[-1]
    ph, pw = (-h) % block, (-w) % block
    if ph or pw:
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 2) + [(0, ph), (0, pw)])
    hb, wb = (h + ph) // block, (w + pw) // block
    x = x.reshape(*x.shape[:-2], hb, block, wb, block)
    return x.sum(axis=(-3, -1))


def xpsnr_block_stats(
    y_ref: jax.Array,
    y_dis: jax.Array,
    y_prev: jax.Array,
    *,
    block: int = BLOCK,
) -> dict[str, jax.Array]:
    """Per-block SSE / spatial activity / temporal activity.

    Inputs: integer luma planes (..., H, W); ``y_prev`` is the previous
    *reference* frame (for the first frame, pass the frame itself -> tact 0).
    Returns uint32 block grids (kernel lib.rs:69-91).
    """
    r = y_ref.astype(jnp.int32)
    d = y_dis.astype(jnp.int32)
    p = y_prev.astype(jnp.int32)
    err = r - d
    sse = block_sums((err * err).astype(jnp.uint32), block)
    sact = block_sums(highpass_3x3(y_ref).astype(jnp.uint32), block)
    tact = block_sums(jnp.abs(r - p).astype(jnp.uint32), block)
    return {"sse": sse, "sact": sact, "tact": tact}


def xpsnr_weights(
    sse: np.ndarray,
    sact: np.ndarray,
    tact: np.ndarray,
    *,
    width: int,
    height: int,
    depth: int = 8,
    block: int = BLOCK,
) -> tuple[float, np.ndarray]:
    """Host-side f64 weighting + final wsse (xpsnr-cuda/src/lib.rs:116-196).

    ``sse``/``sact``/``tact``: (hb, wb) block grids for one frame.
    Returns (wsse_final, weights).  Small frames (<= VGA) get the neighbour
    weight smoothing of the reference's CPU path (lib.rs:135-166).
    """
    sse = sse.astype(np.float64).reshape(-1)
    sact = sact.astype(np.float64).reshape(-1)
    tact = tact.astype(np.float64).reshape(-1)
    nsamples = float(block * block)
    msact = 1.0 + sact / nsamples + 2.0 * tact / nsamples
    msact = np.maximum(msact, float(1 << (depth - 2)))
    weights = 1.0 / msact

    num_blocks = sse.size
    blocks_w = (width + block - 1) // block
    if width * height <= 640 * 480:
        w = weights
        for blk in range(num_blocks):
            if blk % blocks_w == 0:  # first column
                msact_prev = w[blk - 2] if blk > 1 else 0.0
            else:
                if blk % blocks_w > 1:
                    msact_prev = max(w[blk - 2], w[blk])
                else:
                    msact_prev = w[blk]
            if blk > blocks_w:
                msact_prev = max(msact_prev, w[blk - 1 - blocks_w])
            if blk > 0 and w[blk - 1] > msact_prev:
                w[blk - 1] = msact_prev
            if blk == num_blocks - 1 and blk > 0:
                msact_prev = max(w[blk - 1], w[blk - blocks_w])
                w[blk] = min(w[blk], msact_prev)
        weights = w

    wsse = float((weights * sse).sum())
    if wsse < 0.0:
        return 0.0, weights
    r = width * height / (3840.0 * 2160.0)
    avgact = np.sqrt(16.0 * float(1 << (2 * depth - 9)) / np.sqrt(max(r, 0.00001)))
    return float(np.uint64(wsse * avgact + 0.5)), weights


def xpsnr_db(wsse_final: float, *, width: int, height: int, depth: int = 8) -> float:
    """Weighted SSE -> XPSNR in dB."""
    if wsse_final <= 0.0:
        return float("inf")
    maxval = (1 << depth) - 1
    return 10.0 * np.log10((maxval * maxval) * float(width * height) / wsse_final)
