"""NumPy CPU reference for the INTEGER (fixed-point) VIF path — the oracle.

libvmaf's *default* VIF is the fixed-point ``integer_vif.c`` (the reference
project binds libvmaf and therefore gets this path: vmaf/src/lib.rs:160-217);
our float path follows ``float_vif``.  This module pins a fully-specified
fixed-point schedule with libvmaf's structure — Q16 first-pass filter
coefficients rounded from the float taps with the centre tap absorbing the
rounding residue, two separable passes with defined rounding right-shifts
between them, integer products, integer moment statistics, reflect-101
borders — adapted to 32-bit arithmetic (every intermediate is exact in
uint32/int32, see the schedule below), so the device path
(ops/integer_vif.py) can reproduce it BIT-EXACTLY with 32-bit integer ops
(JAX's default integer width).

It is NOT claimed to be bit-identical to libvmaf's integer_vif (whose exact
shift schedule and 64-bit accumulators cannot be verified offline — see
docs/VALIDATION.md for the closure procedure via tools/libvmaf_diff.py);
it IS the integer-convention anchor this repo's device path is gated
against, bit-exactly, at the statistics level.

Fixed-point schedule (depth-8 code values; deeper inputs are pre-rounded
to 8 bits: x8 = (x + 2^(d-9)) >> (d-8)):

  C1 = round(tap * 2^16), centre += 2^16 - sum(C1)     (first pass)
  C2 = round(tap * 2^12), centre += 2^12 - sum(C2)     (second pass)
  vertical:   vx  = (sum_i C1[i] * x[r+i]  + 2^7 ) >> 8    -> Q8  (<= 65280)
              vp  = (sum_i C2[i] * p[r+i]  + 2^11) >> 12   -> Q0  (<= 65025)
                    for the products p in {xx, yy, xy}
  horizontal: mu  = (sum_j C2[j] * vx[c+j] + 2^15) >> 16   -> Q4  (<= 4080)
              pb  = (sum_j C2[j] * vp[c+j] + 2^3 ) >> 4    -> Q8  (< 2^24)
  moments:    s11 = max(pb_xx - mu1*mu1, 0)                 Q8, int32
              s22 = max(pb_yy - mu2*mu2, 0)                 Q8, int32
              s12 = pb_xy - mu1*mu2                         Q8, int32
  next scale: xn  = (sum_j C2[j] * vx[c+j] + 2^19) >> 20   -> Q0 (<= 255),
              decimated [::2, ::2] (the CURRENT scale's window, as in
              libvmaf's vif_dec2).
  scores:     integer guards (s11 == 0, s22 == 0, s12 < 0 replace the
              float path's epsilon tests), then
              g = s12/s11, sv = s22 - g*s12, sigma_nsq in Q8 = 512:
              num += log2(1 + g^2*s11/(max(sv, 1e-10) + 512))
              den += log2(1 + s11/512)

Every blur accumulation has nonnegative terms and a true value < 2^32, so
modulo-2^32 (uint32) arithmetic is exact — that is what makes the schedule
implementable with 32-bit device integers.
"""

from __future__ import annotations

import numpy as np

from turbo_metrics_tpu.ops.vif import NUM_SCALES, vif_window

SIGMA_NSQ_Q8 = 512  # 2.0 in Q8, matching the float path's sigma_nsq = 2


def vif_coeffs_q(scale: int, bits: int) -> np.ndarray:
    """Fixed-point window: round(tap * 2^bits), centre tap absorbs the
    rounding residue so the sum is exactly 2^bits (libvmaf's convention
    for its integer filter tables)."""
    taps = vif_window(scale)
    c = np.round(taps * (1 << bits)).astype(np.int64)
    c[len(c) // 2] += (1 << bits) - c.sum()
    assert c.sum() == 1 << bits and (c >= 0).all()
    return c


def _reflect_idx(n: int, taps: int) -> np.ndarray:
    """reflect-101 gather indices (libvmaf's vif_filter1d mirror rule)."""
    r = taps // 2
    ind = np.arange(n)[:, None] - r + np.arange(taps)[None, :]
    ind = np.abs(ind)
    return np.where(ind >= n, 2 * n - ind - 2, ind)


def _corr_axis_q(x: np.ndarray, c: np.ndarray, axis: int, rshift: int) -> np.ndarray:
    """(sum_k c[k] * x[.. k ..] + 2^(rshift-1)) >> rshift along ``axis``,
    exact int64 (== the uint32 wraparound result: true sums < 2^32)."""
    x = np.moveaxis(np.asarray(x, dtype=np.int64), axis, -1)
    ind = _reflect_idx(x.shape[-1], len(c))
    acc = np.einsum("...ik,k->...i", x[..., ind], c)
    out = (acc + (1 << (rshift - 1))) >> rshift
    return np.moveaxis(out, -1, axis)


def integer_vif_planes(
    ref: np.ndarray, dis: np.ndarray, *, depth: int = 8
) -> list[dict[str, np.ndarray]]:
    """Per-scale integer statistic planes — the bit-exact oracle surface.

    Returns, per scale k in 0..3, dict(s11=, s22=, s12=, mu1=, mu2=) of
    int32 arrays (s* in Q8, mu* in Q4) plus the scale's decimated inputs
    under keys 'ref'/'dis' (Q0 uint8-range int32).
    """
    x = np.asarray(ref, dtype=np.int64)
    y = np.asarray(dis, dtype=np.int64)
    if depth > 8:
        x = (x + (1 << (depth - 9))) >> (depth - 8)
        y = (y + (1 << (depth - 9))) >> (depth - 8)
    out = []
    for k in range(NUM_SCALES):
        c1 = vif_coeffs_q(k, 16)
        c2 = vif_coeffs_q(k, 12)
        if k > 0:
            xv = _corr_axis_q(x, c1, -2, 8)  # Q8
            yv = _corr_axis_q(y, c1, -2, 8)
            x = _corr_axis_q(xv, c2, -1, 20)[..., ::2, ::2]  # Q0
            y = _corr_axis_q(yv, c2, -1, 20)[..., ::2, ::2]
        xv = _corr_axis_q(x, c1, -2, 8)  # Q8
        yv = _corr_axis_q(y, c1, -2, 8)
        mu1 = _corr_axis_q(xv, c2, -1, 16)  # Q4
        mu2 = _corr_axis_q(yv, c2, -1, 16)
        pxx = _corr_axis_q(_corr_axis_q(x * x, c2, -2, 12), c2, -1, 4)  # Q8
        pyy = _corr_axis_q(_corr_axis_q(y * y, c2, -2, 12), c2, -1, 4)
        pxy = _corr_axis_q(_corr_axis_q(x * y, c2, -2, 12), c2, -1, 4)
        s11 = np.maximum(pxx - mu1 * mu1, 0)
        s22 = np.maximum(pyy - mu2 * mu2, 0)
        s12 = pxy - mu1 * mu2
        out.append(
            {
                "s11": s11.astype(np.int32),
                "s22": s22.astype(np.int32),
                "s12": s12.astype(np.int32),
                "mu1": mu1.astype(np.int32),
                "mu2": mu2.astype(np.int32),
                "ref": x.astype(np.int32),
                "dis": y.astype(np.int32),
            }
        )
    return out


def integer_vif_frame(
    ref: np.ndarray, dis: np.ndarray, *, depth: int = 8
) -> dict[str, float]:
    """Integer-convention VIF scores for one frame pair (oracle finish:
    f64 log2 on the exact integer statistics)."""
    planes = integer_vif_planes(ref, dis, depth=depth)
    nums, dens = [], []
    for p in planes:
        s11 = p["s11"].astype(np.float64)
        s22 = p["s22"].astype(np.float64)
        s12 = p["s12"].astype(np.float64)
        zero11 = p["s11"] == 0
        zero22 = p["s22"] == 0
        g = np.where(zero11, 0.0, s12 / np.where(zero11, 1.0, s11))
        sv = s22 - g * s12
        sv = np.where(zero11, s22, sv)
        s11c = np.where(zero11, 0.0, s11)
        sv = np.where(zero22, 0.0, sv)
        g = np.where(zero22, 0.0, g)
        sv = np.where(g < 0.0, s22, sv)
        g = np.maximum(g, 0.0)
        sv = np.maximum(sv, 1e-10)
        num = np.log2(1.0 + g * g * s11c / (sv + SIGMA_NSQ_Q8)).sum()
        den = np.log2(1.0 + s11c / SIGMA_NSQ_Q8).sum()
        nums.append(num)
        dens.append(den)
    nums = np.array(nums)
    dens = np.array(dens)
    per = nums / np.maximum(dens, 1e-30)
    return {
        **{f"vif_scale{k}": float(per[k]) for k in range(NUM_SCALES)},
        "vif": float(nums.sum() / max(dens.sum(), 1e-30)),
    }
