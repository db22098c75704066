"""Gaussian blur used by SSIMULACRA2, as a separable FIR.

The canonical SSIMULACRA2 implementation blurs with a "Recursive Implementation
of the Gaussian Filter Using Truncated Cosine Functions" (Charalampidis 2016)
at sigma = 1.5 (reference: ssimulacra2-cuda/examples/cpu.rs:950-1116, constants
at :931-948; coefficient derivation in ssimulacra2-cuda-kernel/build.rs:29-140).

Key observation for this rebuild: that recursion is *not* an IIR filter in
disguise — it is an exact FIR filter of radius 5.  The recurrence

    out[n] = c_in * (x[n-R-1] + x[n+R-1]) + c_prev * out[n-1] - out[n-2]

per cosine component is a marginally-stable oscillator (poles on the unit
circle at e^{±i·k·pi/10}, k in {1,3,5}); the two input kicks at offsets
-(R+1) and +(R-1) are phased so the oscillation cancels exactly outside a
window of 2R+1 = 11 taps.  The impulse response is therefore a finite,
symmetric 11-tap kernel — we derive it numerically from the recurrence below
and apply it as a separable shifted-add convolution, which XLA fuses into
elementwise passes instead of a sequential scan.

Border handling matches the reference: zero padding, no renormalisation.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Filter recurrence constants (f32 values from the canonical implementation,
# ssimulacra2-cuda/examples/cpu.rs:931-948), widened to f64.
RADIUS = 5
_MUL_IN = np.float32([0.055295236, -0.058836687, 0.012955819]).astype(np.float64)
_MUL_PREV = np.float32([1.9021131, 1.1755705, 1.2246469e-16]).astype(np.float64)


def _impulse_response(length: int = 4096) -> np.ndarray:
    """Run the reference recurrence on a unit impulse, in f64."""
    center = length // 2
    x = np.zeros(length, dtype=np.float64)
    x[center] = 1.0
    out = np.zeros(length, dtype=np.float64)
    prev = np.zeros(3, dtype=np.float64)
    prev2 = np.zeros(3, dtype=np.float64)
    for n in range(-RADIUS + 1, length):
        left = n - RADIUS - 1
        right = n + RADIUS - 1
        s = (x[left] if left >= 0 else 0.0) + (x[right] if 0 <= right < length else 0.0)
        cur = s * _MUL_IN + _MUL_PREV * prev - prev2
        prev2, prev = prev, cur
        if n >= 0:
            out[n] = cur.sum()
    return out, center


@functools.lru_cache(maxsize=None)
def gaussian_taps() -> np.ndarray:
    """The 11 FIR taps equivalent to the reference recursive Gaussian (f64).

    Also asserts that the truncation residual (the tiny undamped oscillation
    left over because the reference's constants are f32-rounded) is negligible.
    """
    h, center = _impulse_response(length=512)
    taps = h[center - RADIUS : center + RADIUS + 1].copy()
    tail = np.concatenate([h[: center - RADIUS], h[center + RADIUS + 1 :]])
    # Because the reference's recurrence constants are f32-rounded, the
    # oscillator cancellation is imperfect: a zero-mean oscillating tail of
    # amplitude ~1.4e-7 persists.  It integrates to ~0 against any signal, so
    # truncating it is safe; we only guard against gross derivation bugs here.
    assert np.abs(tail).max() < 1e-6, "recursive-gaussian tail unexpectedly large"
    return taps


def blur_2d(x: jax.Array, *, taps: np.ndarray | None = None) -> jax.Array:
    """Separable 11-tap Gaussian blur over the last two axes (zero-padded).

    Matches the reference's horizontal+vertical recursive passes
    (examples/cpu.rs:913-928) up to f32 rounding.  Input shape (..., H, W).
    """
    if taps is None:
        taps = gaussian_taps()
    t = [jnp.asarray(v, dtype=x.dtype) for v in taps]
    n = 2 * RADIUS + 1

    h_dim, w_dim = x.shape[-2], x.shape[-1]
    pad_cfg = [(0, 0)] * (x.ndim - 1) + [(RADIUS, RADIUS)]
    xp = jnp.pad(x, pad_cfg)
    x = sum(t[k] * jax.lax.slice_in_dim(xp, k, k + w_dim, axis=-1) for k in range(n))

    pad_cfg = [(0, 0)] * (x.ndim - 2) + [(RADIUS, RADIUS), (0, 0)]
    xp = jnp.pad(x, pad_cfg)
    x = sum(t[k] * jax.lax.slice_in_dim(xp, k, k + h_dim, axis=-2) for k in range(n))
    return x


def _iir_pass(x: jax.Array) -> jax.Array:
    """One faithful f32 recursive-Gaussian pass along axis 0 of (L, N).

    Same recurrence and operation order as the reference implementations
    (examples/cpu.rs:950-1116; refimpl/ssimulacra2.py _blur_pass):

        cur = (x[n-R-1] + x[n+R-1]) * MUL_IN + MUL_PREV * prev - prev2
        out[n] = cur.sum()  (3 cosine components, f32 throughout)

    Sequential along the filter axis by construction — implemented as a
    jax.lax.scan; this is the parity mode, not the throughput path.
    """
    mul_in = jnp.asarray(
        np.float32([0.055295236, -0.058836687, 0.012955819])[:, None]
    )
    mul_prev = jnp.asarray(
        np.float32([1.9021131, 1.1755705, 1.2246469e-16])[:, None]
    )
    length, lanes = x.shape
    r = RADIUS
    # Input-kick sequence for n in [-R+1, length): s[k] = x[k-2R] + x[k]
    # with zero padding out of range (k = n + R - 1).
    left = jnp.pad(x, ((2 * r, 0), (0, 0)))[: length + r - 1]
    right = jnp.pad(x, ((0, r - 1), (0, 0)))
    s_seq = left + right

    def step(carry, s):
        prev, prev2 = carry
        cur = s[None, :] * mul_in + mul_prev * prev - prev2
        return (cur, prev), cur.sum(axis=0)

    init = (
        jnp.zeros((3, lanes), jnp.float32),
        jnp.zeros((3, lanes), jnp.float32),
    )
    _, ys = jax.lax.scan(step, init, s_seq)
    return ys[r - 1 :]


def blur_2d_iir(x: jax.Array) -> jax.Array:
    """Faithful f32 recursive-Gaussian blur over the last two axes.

    Horizontal pass then vertical, like the reference (examples/
    cpu.rs:913-928).  Bit-faithful in structure to the f32 recursion, so it
    tracks the reference implementations' rounding drift — use for tight
    score parity against the canonical CPU implementations; ~10x slower
    than the FIR path (two sequential scans per plane).
    """
    x = x.astype(jnp.float32)
    shape = x.shape
    h_dim, w_dim = shape[-2], shape[-1]
    lead = int(np.prod(shape[:-2], dtype=np.int64)) if x.ndim > 2 else 1
    # Horizontal: scan along W with (lead*H) lanes.
    xt = jnp.moveaxis(x.reshape(lead, h_dim, w_dim), -1, 0).reshape(w_dim, -1)
    xt = _iir_pass(xt)
    x = jnp.moveaxis(xt.reshape(w_dim, lead, h_dim), 0, -1)
    # Vertical: scan along H.
    xv = jnp.moveaxis(x, -2, 0).reshape(h_dim, -1)
    xv = _iir_pass(xv)
    x = jnp.moveaxis(xv.reshape(h_dim, lead, w_dim), 0, -2)
    return x.reshape(shape)


def gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """Sampled (true) Gaussian window, normalised to sum 1 (f64).

    Used by the classic SSIM / MS-SSIM metrics (Wang et al.), *not* by
    SSIMULACRA2 (which uses :func:`gaussian_taps`).
    """
    half = (size - 1) / 2.0
    g = np.exp(-((np.arange(size) - half) ** 2) / (2.0 * sigma**2))
    return g / g.sum()
