"""ADM (adm2) elementary feature, following libvmaf's float-ADM conventions.

The last VMAF elementary feature (alongside motion and VIF).  The reference
project has no ADM of its own — it binds libvmaf and reads back
``VMAF_feature_adm2_score`` (reference vmaf/src/lib.rs:160-217), so parity
means agreeing with libvmaf's pipeline.  This implements the float-ADM
("adm2") conventions of libvmaf's ``src/feature/adm.c``/``adm_tools.c``
structure (itself the Detail Loss Metric of Li, Lukin et al. 2011):

  1. 4-level 2-D Daubechies-2 DWT, orthonormal taps, symmetric half-sample
     border extension, output index i reads input ``2*i - 1 + tap`` (odd
     sizes round up, matching libvmaf's ``(n+1)/2`` band sizes).
  2. Decoupling per detail subband b in {H, V, D}:
     ``k = t/(o + 1e-30)`` clipped to [0, 1], restored ``r = k*o``; where the
     (H,V) gradient vectors of ref and dis agree within 1 degree — tested as
     ``dot >= 0 and dot^2 >= cos^2(1deg) * |o|^2 * |t|^2``, no atan2 — the
     distorted detail is adopted verbatim (``r = t``).  Additive impairment
     ``a = t - r``.
  3. CSF weighting per level/orientation: reciprocal of the Watson-Yang-
     Solomon-Villasenor (1997) DWT quantization step
     ``Q = 2 a 10^(k log10(2^(level+1) f0 g / r)^2) / g`` with the paper's
     Y-channel db9/7 parameters a=0.495, k=0.466, f0=0.401 and orientation
     gains g = 1.0 (H, V) / 0.534 (D), at display visual resolution
     r = 3.0 (view dist, heights) * 1080 (display height) * pi/180.
  4. Contrast masking: one threshold map per level accumulating all three
     CSF'd additive bands through a 3x3 filter with centre weight 1/15 and
     1/30 elsewhere (reflect-101 borders); masked detail
     ``max(|csf*r| - thr, 0)``.
  5. Pooling: per band, Minkowski 3-norm over the centre region (border
     ``int(dim*0.1 - 0.5)`` cropped per side) **plus** the stabilising term
     ``cbrt(region_area / 32)`` added to each band's norm; per-scale and
     total scores are num/den with a ``1e-10 * (w*h)/(1920*1080)`` floor
     under which they clamp to 0 (den == 0 scores 1.0).

Inputs are luma in 8-bit code-value units.  libvmaf feeds luma - 128; with
symmetric extension every filter here is exactly shift-invariant for the
detail bands, so the offset is a no-op and omitted.

The device half (``adm_stats``) returns per-scale/per-band centre-region
cube sums; the cube roots, stabilisers and score ratios run on host in f64
(``adm_score``).  Oracle: refimpl/adm.py, an independent NumPy
implementation of the same specification.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

NUM_LEVELS = 4
BORDER_FACTOR = 0.1
# Watson et al. (1997) DWT quantization-step model, Y channel, 9/7 wavelet
# (libvmaf dwt_7_9_YCbCr_threshold): a, k, f0, orientation gains g.
WATSON_A = 0.495
WATSON_K = 0.466
WATSON_F0 = 0.401
WATSON_G = (1.501, 1.0, 0.534, 1.0)  # indexed: approx, H/V, diagonal
NORM_VIEW_DIST = 3.0  # libvmaf DEFAULT_ADM_NORM_VIEW_DIST
REF_DISPLAY_HEIGHT = 1080  # libvmaf DEFAULT_ADM_REF_DISPLAY_HEIGHT
NUMDEN_LIMIT = 1e-10  # scaled by (w*h)/(1920*1080)
COS_1DEG_SQ = float(np.cos(np.pi / 180.0) ** 2)
DECOUPLE_EPS = 1e-30

_SQRT3 = np.sqrt(3.0)
DB2_LO = np.array(
    [1.0 + _SQRT3, 3.0 + _SQRT3, 3.0 - _SQRT3, 1.0 - _SQRT3], dtype=np.float64
) / (4.0 * np.sqrt(2.0))
DB2_HI = np.array([DB2_LO[3], -DB2_LO[2], DB2_LO[1], -DB2_LO[0]], dtype=np.float64)


def dwt_quant_step(level: int, theta: int) -> float:
    """Watson DWT quantization step Q(level, orientation) at the default
    display visual resolution (56.55 px/degree)."""
    r = NORM_VIEW_DIST * REF_DISPLAY_HEIGHT * np.pi / 180.0
    g = WATSON_G[theta]
    temp = np.log10((2.0 ** (level + 1)) * WATSON_F0 * g / r)
    return float(2.0 * WATSON_A * 10.0 ** (WATSON_K * temp * temp) / g)


def csf_rfactors(level: int) -> tuple[float, float]:
    """(1/Q for H and V bands, 1/Q for the diagonal band) at a level."""
    return 1.0 / dwt_quant_step(level, 1), 1.0 / dwt_quant_step(level, 2)


def band_sizes(h: int, w: int) -> list[tuple[int, int]]:
    """Detail-band (h, w) per DWT level (libvmaf's ceil halving)."""
    out = []
    for _ in range(NUM_LEVELS):
        h, w = (h + 1) // 2, (w + 1) // 2
        out.append((h, w))
    return out


def center_region(h: int, w: int) -> tuple[int, int, int, int]:
    """(top, bottom, left, right) of the pooled centre region, libvmaf's
    ``int(dim * border_factor - 0.5)`` crop per side."""
    left = max(0, int(w * BORDER_FACTOR - 0.5))
    top = max(0, int(h * BORDER_FACTOR - 0.5))
    return top, h - top, left, w - left


def _filter_dec(x: jax.Array, taps: np.ndarray, axis: int = -1) -> jax.Array:
    """DWT analysis along ``axis`` (-1 or -2): symmetric extension, output
    index i correlates taps against input starting at 2*i - 1, ceil(d/2)
    outputs (libvmaf adm_dwt2 convention).

    The tap accumulation runs at full width and the stride-2 decimation
    happens once on the accumulated result — selecting even positions
    commutes exactly with the weighted add.  The column direction
    (axis=-2) filters in place, so the DWT needs no transposes."""
    n = len(taps)
    w = [jnp.float32(v) for v in taps]
    d = x.shape[axis]
    co = (d + 1) // 2
    pads = [(0, 0)] * x.ndim
    pads[axis if axis >= 0 else x.ndim + axis] = (1, n - 1 + (2 * co - d))
    xp = jnp.pad(x, pads, mode="symmetric")
    acc = None
    for k in range(n):
        s = jax.lax.slice_in_dim(xp, k, k + 2 * co, axis=axis)
        acc = s * w[k] if acc is None else acc + s * w[k]
    if axis in (-1, x.ndim - 1):
        return acc.reshape(*acc.shape[:-1], co, 2)[..., 0]
    return acc.reshape(*acc.shape[:-2], co, 2, acc.shape[-1])[..., 0, :]


def _dwt_level(x: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """One 2-D db2 DWT level of (..., H, W) -> (A, H, V, D) at ceil-half size."""
    lo_r = _filter_dec(x, DB2_LO)
    hi_r = _filter_dec(x, DB2_HI)
    a = _filter_dec(lo_r, DB2_LO, axis=-2)
    v = _filter_dec(lo_r, DB2_HI, axis=-2)  # vertical detail
    h = _filter_dec(hi_r, DB2_LO, axis=-2)  # horizontal detail
    d = _filter_dec(hi_r, DB2_HI, axis=-2)
    return a, h, v, d


def _mask_filter(x: jax.Array) -> jax.Array:
    """3x3 masking filter: centre 1/15, others 1/30, reflect-101 borders."""
    h, w = x.shape[-2], x.shape[-1]
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 2) + [(1, 1), (1, 1)], mode="reflect")
    acc = None
    for dy in range(3):
        for dx in range(3):
            f = np.float32(1.0 / 15.0 if (dy == 1 and dx == 1) else 1.0 / 30.0)
            s = jax.lax.slice_in_dim(
                jax.lax.slice_in_dim(xp, dy, dy + h, axis=-2), dx, dx + w, axis=-1
            )
            acc = s * f if acc is None else acc + s * f
    return acc


def adm_stats(
    y_ref: jax.Array, y_dis: jax.Array, *, integer: bool = False,
    depth: int = 8,
) -> jax.Array:
    """Per-scale, per-band centre-region cube sums for (B, H, W) f32 luma.

    Returns (B, NUM_LEVELS, 3, 2): [..., b, 0] = sum |masked csf*r_b|^3,
    [..., b, 1] = sum |csf*o_b|^3 over the centre region, bands b = (H, V, D).

    ``integer=True`` selects the fixed-point path matching libvmaf's
    default integer-ADM conventions (ops/integer_adm.py; inputs are then
    integer code values at ``depth`` bits) — an opt-in fidelity mode,
    bit-exact at the band/angle-gate level vs refimpl/integer_adm.py.
    """
    if integer:
        from turbo_metrics_tpu.ops.integer_adm import integer_adm_stats

        return integer_adm_stats(y_ref, y_dis, depth=depth)
    o = y_ref.astype(jnp.float32)
    t = y_dis.astype(jnp.float32)
    eps = np.float32(DECOUPLE_EPS)
    out = []
    for level in range(NUM_LEVELS):
        o_a, o_h, o_v, o_d = _dwt_level(o)
        t_a, t_h, t_v, t_d = _dwt_level(t)

        # Decoupling (libvmaf adm_decouple_s).
        ot_dp = o_h * t_h + o_v * t_v
        o_mag_sq = o_h * o_h + o_v * o_v
        t_mag_sq = t_h * t_h + t_v * t_v
        angle_ok = (ot_dp >= 0.0) & (
            ot_dp * ot_dp >= np.float32(COS_1DEG_SQ) * o_mag_sq * t_mag_sq
        )

        rf_hv, rf_d = csf_rfactors(level)
        rfs = (np.float32(rf_hv), np.float32(rf_hv), np.float32(rf_d))

        csf_r, csf_a, csf_o = [], [], []
        for o_b, t_b, rf in zip((o_h, o_v, o_d), (t_h, t_v, t_d), rfs):
            k = jnp.clip(t_b / (o_b + eps), 0.0, 1.0)
            r = jnp.where(angle_ok, t_b, k * o_b)
            csf_r.append(rf * r)
            csf_a.append(rf * (t_b - r))
            csf_o.append(rf * o_b)

        # One masking threshold map accumulating all three additive bands.
        thr = None
        for a_b in csf_a:
            m = _mask_filter(jnp.abs(a_b))
            thr = m if thr is None else thr + m

        hh, ww = o_h.shape[-2], o_h.shape[-1]
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
        out.append(jnp.stack(bands, axis=-2))  # (B, 3, 2)
        o, t = o_a, t_a
    return jnp.stack(out, axis=-3)  # (B, 4, 3, 2)


def adm_score(
    stats: np.ndarray, height: int, width: int
) -> dict[str, np.ndarray]:
    """(..., 4, 3, 2) cube sums -> {'adm2', 'adm_scale0..3'} (libvmaf adm.c
    final pooling: per-band cbrt + cbrt(area/32) stabiliser, numden floor)."""
    stats = np.asarray(stats, dtype=np.float64)
    sizes = band_sizes(height, width)
    num_scale = np.zeros(stats.shape[:-3] + (NUM_LEVELS,))
    den_scale = np.zeros_like(num_scale)
    for level, (hh, ww) in enumerate(sizes):
        top, bottom, left, right = center_region(hh, ww)
        stab = np.cbrt((bottom - top) * (right - left) / 32.0)
        num_scale[..., level] = (
            np.cbrt(np.maximum(stats[..., level, :, 0], 0.0)) + stab
        ).sum(axis=-1)
        den_scale[..., level] = (
            np.cbrt(np.maximum(stats[..., level, :, 1], 0.0)) + stab
        ).sum(axis=-1)

    limit = NUMDEN_LIMIT * (width * height) / (1920.0 * 1080.0)

    def ratio(num, den):
        num = np.where(num < limit, 0.0, num)
        den = np.where(den < limit, 0.0, den)
        return np.where(den == 0.0, 1.0, num / np.where(den == 0.0, 1.0, den))

    out = {
        f"adm_scale{k}": ratio(num_scale[..., k], den_scale[..., k])
        for k in range(NUM_LEVELS)
    }
    out["adm2"] = ratio(num_scale.sum(axis=-1), den_scale.sum(axis=-1))
    return out
