"""Integer (fixed-point) ADM device path — libvmaf's default-convention
analog, 32-bit schedule.

Implements the exact schedule specified in ``refimpl/integer_adm.py``
(Q13 normalised db2 taps, Q8 int32 bands, defined rounding shifts,
integer Q2 decoupling angle gate) with jnp i32 ops; the decoupling ratio,
CSF weighting, masking and pooling reuse the float pipeline's math on the
integer-exact bands dequantised to orthonormal units (band * 2^(level+1)
/ 2^8).  Bit-exact vs the oracle at the band/gate level; the float finish
is gated at tolerance in tests.

A notable practical benefit over the float path: the decoupling angle
gate — DISCONTINUOUS in the float formulation, where ~1e-6 of f32
summation-order rounding can flip near-tie pixels — is decided on exact
integers here, so it is reproducible across platforms by construction.

Opt-in via ``ops.adm.adm_stats(..., integer=True)``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from turbo_metrics_tpu.ops.adm import NUM_LEVELS, center_region, csf_rfactors
from turbo_metrics_tpu.refimpl.integer_adm import (
    COS_1DEG_SQ_F32,
    Q_BAND,
    Q_TAPS,
    adm_coeffs_q,
)


def _filter_dec_q(x: jax.Array, c: np.ndarray) -> jax.Array:
    """Integer DWT analysis along the last axis (symmetric extension,
    output i reads input 2i-1+k, ceil-half outputs), rounded >> Q_TAPS."""
    n = len(c)
    d = x.shape[-1]
    co = (d + 1) // 2
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(1, n - 1)], mode="symmetric")
    acc = None
    for k in range(n):
        s = jax.lax.slice_in_dim(xp, k, k + 2 * co, axis=-1)
        s = s.reshape(*s.shape[:-1], co, 2)[..., 0]
        term = jnp.int32(int(c[k])) * s
        acc = term if acc is None else acc + term
    return (acc + jnp.int32(1 << (Q_TAPS - 1))) >> Q_TAPS


def _dwt_level_q(x: jax.Array):
    lo, hi = adm_coeffs_q()
    lo_r = _filter_dec_q(x, lo)
    hi_r = _filter_dec_q(x, hi)

    def cols(y, c):
        return jnp.swapaxes(_filter_dec_q(jnp.swapaxes(y, -1, -2), c), -1, -2)

    return cols(lo_r, lo), cols(hi_r, lo), cols(lo_r, hi), cols(hi_r, hi)


def integer_adm_levels(
    ref: jax.Array, dis: jax.Array, *, depth: int = 8
) -> list[dict[str, jax.Array]]:
    """Per-level integer bands (int32 Q8) + angle mask — the bit-exact
    oracle surface.  Inputs: (..., H, W) integer luma."""
    x = ref.astype(jnp.int32)
    y = dis.astype(jnp.int32)
    if depth > 8:
        x = (x + jnp.int32(1 << (depth - 9))) >> (depth - 8)
        y = (y + jnp.int32(1 << (depth - 9))) >> (depth - 8)
    o = (x - 128) << Q_BAND
    t = (y - 128) << Q_BAND
    out = []
    for _ in range(NUM_LEVELS):
        o_a, o_h, o_v, o_d = _dwt_level_q(o)
        t_a, t_h, t_v, t_d = _dwt_level_q(t)
        oh2, ov2 = o_h >> 6, o_v >> 6
        th2, tv2 = t_h >> 6, t_v >> 6
        dp = oh2 * th2 + ov2 * tv2
        omag = oh2 * oh2 + ov2 * ov2
        tmag = th2 * th2 + tv2 * tv2
        dpf = dp.astype(jnp.float32)
        angle_ok = (dp >= 0) & (
            dpf * dpf
            >= COS_1DEG_SQ_F32
            * (omag.astype(jnp.float32) * tmag.astype(jnp.float32))
        )
        out.append(
            {
                "o_h": o_h, "o_v": o_v, "o_d": o_d,
                "t_h": t_h, "t_v": t_v, "t_d": t_d,
                "angle_ok": angle_ok,
            }
        )
        o, t = o_a, t_a
    return out


def _mask_filter(x: jax.Array) -> jax.Array:
    from turbo_metrics_tpu.ops.adm import _mask_filter as f

    return f(x)


def integer_adm_stats(
    ref: jax.Array, dis: jax.Array, *, depth: int = 8
) -> jax.Array:
    """Per-scale, per-band centre-region cube sums under the integer
    conventions.  (B, H, W) integer luma -> (B, 4, 3, 2), same shape and
    meaning as the float ``adm_stats`` so ``adm_score`` applies unchanged."""
    levels = integer_adm_levels(ref, dis, depth=depth)
    out = []
    for li, lv in enumerate(levels):
        scale = np.float32((1 << (li + 1)) / (1 << Q_BAND))
        rf_hv, rf_d = csf_rfactors(li)
        rfs = (np.float32(rf_hv), np.float32(rf_hv), np.float32(rf_d))
        csf_r, csf_a, csf_o = [], [], []
        for bi, (ob, tb) in enumerate(
            (("o_h", "t_h"), ("o_v", "t_v"), ("o_d", "t_d"))
        ):
            o_b = lv[ob].astype(jnp.float32) * scale
            t_b = lv[tb].astype(jnp.float32) * scale
            k = jnp.clip(t_b / (o_b + np.float32(1e-30)), 0.0, 1.0)
            r = jnp.where(lv["angle_ok"], t_b, k * o_b)
            csf_r.append(rfs[bi] * r)
            csf_a.append(rfs[bi] * (t_b - r))
            csf_o.append(rfs[bi] * o_b)
        thr = None
        for a_b in csf_a:
            m = _mask_filter(jnp.abs(a_b))
            thr = m if thr is None else thr + m
        hh, ww = lv["o_h"].shape[-2], lv["o_h"].shape[-1]
        top, bottom, left, right = center_region(hh, ww)
        bands = []
        for r_b, o_b in zip(csf_r, csf_o):
            rm = jnp.maximum(jnp.abs(r_b) - thr, 0.0)
            rm = rm[..., top:bottom, left:right]
            oc = jnp.abs(o_b)[..., top:bottom, left:right]
            bands.append(
                jnp.stack(
                    [
                        jnp.sum(rm * rm * rm, axis=(-2, -1)),
                        jnp.sum(oc * oc * oc, axis=(-2, -1)),
                    ],
                    axis=-1,
                )
            )
        out.append(jnp.stack(bands, axis=-2))
    return jnp.stack(out, axis=-3)
