"""Device-vs-oracle parity: every metric family against its NumPy oracle.

Each family's device path (the jnp ops the engine runs, compiled by XLA for
the default device) is compared with its oracle in ``refimpl/`` on the same
frames.  Integer families must agree bit for bit; float families within a
stated budget.  ``chip_smoke.py`` runs this at 1080p on the GPU; the CPU
tests run it at small shapes.

The device paths contain no dot or convolution, so no TF32 contraction is
involved; a contraction added later must state its ``precision``.
"""

from __future__ import annotations

from concurrent.futures import Executor
from dataclasses import dataclass

import jax
import numpy as np

from turbo_metrics_tpu.models.ssimulacra2 import ssimulacra2_subscores
from turbo_metrics_tpu.models.ssimulacra2_score import postprocess_score
from turbo_metrics_tpu.ops import quality
from turbo_metrics_tpu.ops.adm import adm_score, adm_stats
from turbo_metrics_tpu.ops.colorspace import yuv420_to_linear_rgb
from turbo_metrics_tpu.ops.downscale import scale_dims
from turbo_metrics_tpu.ops.integer_adm import integer_adm_levels
from turbo_metrics_tpu.ops.integer_vif import integer_vif_scale_planes
from turbo_metrics_tpu.ops.vif import vif_scale_stats, vif_scores
from turbo_metrics_tpu.ops.vmaf_motion import integer_blur
from turbo_metrics_tpu.ops.xpsnr_ops import xpsnr_block_stats
from turbo_metrics_tpu.refimpl import adm as adm_oracle
from turbo_metrics_tpu.refimpl import colorspace as conv_oracle
from turbo_metrics_tpu.refimpl import integer_adm as iadm_oracle
from turbo_metrics_tpu.refimpl import integer_vif as ivif_oracle
from turbo_metrics_tpu.refimpl import quality as quality_oracle
from turbo_metrics_tpu.refimpl import ssimulacra2 as s2_oracle
from turbo_metrics_tpu.refimpl import vif as vif_oracle
from turbo_metrics_tpu.refimpl import vmaf_motion as motion_oracle
from turbo_metrics_tpu.refimpl import xpsnr as xpsnr_oracle


@dataclass(frozen=True)
class Budget:
    value: float
    unit: str
    reason: str


# Largest |device - oracle| accepted per family, over every frame pair and
# every compared value.  The float budgets allow f32 arithmetic, with sums
# in XLA's reduction order, against the oracles' f64 (or sequential f32)
# arithmetic; each is at least twice the largest delta the CPU backend
# shows on the test shapes, and far below the metric's reported precision.
BUDGETS = {
    "conversion": Budget(
        2e-4, "linear light",
        "f32 transfer powers vs f64; PQ's 1/m1 = 6.3 exponent amplifies "
        "f32 rounding to ~5e-5",
    ),
    "ssimulacra2": Budget(
        0.05, "score", "BASELINE.md parity budget; FIR blur vs the same "
        "filter with f64 map sums",
    ),
    "ssimulacra2_iir": Budget(
        0.05, "score", "BASELINE.md parity budget; f32 recursive blur vs "
        "the same recursion in NumPy",
    ),
    "psnr": Budget(
        1e-3, "dB", "f32 mean of squared errors (exact integers per "
        "sample) vs f64",
    ),
    "ssim": Budget(
        1e-4, "index", "f32 windowed moments (E[x^2] - mu^2 cancellation "
        "at 8-bit code values) vs f64",
    ),
    "msssim": Budget(1e-4, "index", "as ssim, over five levels"),
    "vif": Budget(
        1e-3, "score", "f32 log2 terms summed over the frame vs f64, per "
        "scale and overall",
    ),
    "adm": Budget(
        1e-3, "score", "f32 cubed-band sums over the frame vs f64, per "
        "scale and adm2",
    ),
    "xpsnr_stats": Budget(0, "count", "integer block sums: bit-exact"),
    "motion": Budget(0, "code value", "integer blur and SAD: bit-exact"),
    "vif_integer": Budget(
        0, "count", "fixed-point statistics planes: bit-exact"
    ),
    "adm_integer": Budget(
        0, "count", "fixed-point DWT bands and angle gate: bit-exact"
    ),
}


@dataclass(frozen=True)
class Row:
    family: str
    delta: float
    budget: Budget

    @property
    def ok(self) -> bool:
        return bool(self.delta <= self.budget.value)

    def line(self) -> str:
        return (
            f"{self.family:16s} max|delta| {self.delta:.3e} "
            f"budget {self.budget.value:g} {self.budget.unit:10s} "
            f"{'OK' if self.ok else 'FAIL'}  ({self.budget.reason})"
        )


def synthetic_clip(
    seed: int, n: int, height: int, width: int, *, depth: int = 8
):
    """``n`` reference and distorted 4:2:0 limited-range (y, u, v) frames.

    Moving smooth structure plus fixed texture; the distorted side adds
    integer noise of about 1.5% of the code range to luma and chroma."""
    rng = np.random.default_rng(seed)
    shift = depth - 8
    dt = np.uint8 if depth == 8 else np.uint16
    ch, cw = (height + 1) // 2, (width + 1) // 2
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    cy, cx = np.mgrid[0:ch, 0:cw].astype(np.float32)
    texture = rng.normal(0.0, 6.0, (height, width)).astype(np.float32)
    lo, luma_hi, chroma_hi = 16 << shift, 235 << shift, 240 << shift
    refs, diss = [], []
    for t in range(n):
        luma = (
            126.0
            + 60.0 * np.sin(xx / 23.0 + 0.31 * t) * np.cos(yy / 17.0)
            + 30.0 * np.sin((xx + yy) / 41.0 + 0.17 * t)
            + texture
        ) * (1 << shift)
        u = (128.0 + 40.0 * np.sin(cx / 29.0 - 0.2 * t)) * (1 << shift)
        v = (128.0 + 40.0 * np.cos(cy / 31.0 + 0.1 * t)) * (1 << shift)
        planes = (
            np.clip(np.rint(luma), lo, luma_hi),
            np.clip(np.rint(u), lo, chroma_hi),
            np.clip(np.rint(v), lo, chroma_hi),
        )
        amp = 4 << shift
        noisy = tuple(
            np.clip(p + rng.integers(-amp, amp + 1, p.shape), lo, hi)
            for p, hi in zip(planes, (luma_hi, chroma_hi, chroma_hi))
        )
        refs.append(tuple(p.astype(dt) for p in planes))
        diss.append(tuple(p.astype(dt) for p in noisy))
    return refs, diss


# -- oracle side (host NumPy; module-level so an executor can run them) -----

def _oracle_conversion(y, u, v):
    return conv_oracle.yuv_to_linear_rgb(y, u, v)


def _oracle_ssimulacra2(lin_ref, lin_dis, blur_impl):
    return s2_oracle.compute_ssimulacra2(
        lin_ref.transpose(1, 2, 0), lin_dis.transpose(1, 2, 0),
        blur_impl=blur_impl,
    )


def _oracle_quality(q_ref, q_dis):
    return {
        "psnr": quality_oracle.psnr(q_ref, q_dis),
        "ssim": quality_oracle.ssim(q_ref, q_dis),
        "msssim": quality_oracle.msssim(q_ref, q_dis),
    }


def _oracle_xpsnr(y_ref, y_dis, y_prev):
    r = y_ref.astype(np.int64)
    return {
        "sse": xpsnr_oracle.block_sums((r - y_dis) ** 2),
        "sact": xpsnr_oracle.block_sums(xpsnr_oracle.highpass_abs(y_ref)),
        "tact": xpsnr_oracle.block_sums(np.abs(r - y_prev)),
    }


def _oracle_vmaf(y_ref, y_dis):
    return {
        "vif": vif_oracle.vif_frame(y_ref, y_dis),
        "adm": adm_oracle.adm_frame(y_ref, y_dis),
        "vif_integer": ivif_oracle.integer_vif_planes(y_ref, y_dis),
        "adm_integer": iadm_oracle.integer_adm_levels(y_ref, y_dis),
    }


def _oracle_motion_blur(y):
    return motion_oracle.integer_blur(y)


class _Inline:
    """Executor stand-in that runs each task when it is submitted."""

    class _Done:
        def __init__(self, value):
            self._value = value

        def result(self):
            return self._value

    def submit(self, fn, *args):
        return self._Done(fn(*args))


def submit_oracles(refs, diss, executor: Executor | None = None) -> dict:
    """Start every oracle computation for the frame pairs; returns futures.

    The oracles take only host data derived from the frames, so they can run
    in worker processes while the device works on something else."""
    ex = executor if executor is not None else _Inline()
    lin = [ex.submit(_oracle_conversion, *f) for f in refs + diss]
    lin = [f.result() for f in lin]
    n = len(refs)
    lin_ref, lin_dis = lin[:n], lin[n:]
    q_ref = [np.clip(np.round(x.astype(np.float32) * 255.0), 0, 255) for x in lin_ref]
    q_dis = [np.clip(np.round(x.astype(np.float32) * 255.0), 0, 255) for x in lin_dis]
    y_ref = [f[0] for f in refs]
    y_dis = [f[0] for f in diss]
    prev = [y_ref[0]] + y_ref[:-1]
    return {
        "lin_ref": lin_ref,
        "lin_dis": lin_dis,
        "q_ref": q_ref,
        "q_dis": q_dis,
        "ssimulacra2": [
            ex.submit(_oracle_ssimulacra2, r.astype(np.float32),
                      d.astype(np.float32), "fir")
            for r, d in zip(lin_ref, lin_dis)
        ],
        "ssimulacra2_iir": [
            ex.submit(_oracle_ssimulacra2, r.astype(np.float32),
                      d.astype(np.float32), "iir")
            for r, d in zip(lin_ref, lin_dis)
        ],
        "quality": [
            ex.submit(_oracle_quality, r.astype(np.float64), d.astype(np.float64))
            for r, d in zip(q_ref, q_dis)
        ],
        "xpsnr": [
            ex.submit(_oracle_xpsnr, r, d, p)
            for r, d, p in zip(y_ref, y_dis, prev)
        ],
        "vmaf": [ex.submit(_oracle_vmaf, r, d) for r, d in zip(y_ref, y_dis)],
        "motion_blur": [ex.submit(_oracle_motion_blur, y) for y in y_ref],
    }


# -- device side -------------------------------------------------------------

def _device_outputs(refs, diss, lin_ref, lin_dis, q_ref, q_dis) -> dict:
    """Every family on the default device, batched over the frame pairs."""
    y_r = np.stack([f[0] for f in refs])
    uv_r = np.stack([np.stack([f[1], f[2]], -1) for f in refs])
    y_d = np.stack([f[0] for f in diss])
    h, w = y_r.shape[-2:]
    num_scales = len(scale_dims(h, w))
    lin_r = np.stack(lin_ref).astype(np.float32)
    lin_d = np.stack(lin_dis).astype(np.float32)
    q_r = np.stack(q_ref).astype(np.float32)
    q_d = np.stack(q_dis).astype(np.float32)
    prev = np.concatenate([y_r[:1], y_r[:-1]])
    y_rf = y_r.astype(np.float32)
    y_df = y_d.astype(np.float32)

    def fetch(fn, *args):
        return jax.tree_util.tree_map(np.asarray, jax.jit(fn)(*args))

    out = {
        "conversion": fetch(yuv420_to_linear_rgb, y_r, uv_r),
        "ssimulacra2": postprocess_score(np.asarray(fetch(
            lambda a, b: ssimulacra2_subscores(a, b, num_scales=num_scales),
            lin_r, lin_d,
        ), np.float64)),
        "ssimulacra2_iir": postprocess_score(np.asarray(fetch(
            lambda a, b: ssimulacra2_subscores(
                a, b, num_scales=num_scales, backend="jnp_iir"
            ),
            lin_r, lin_d,
        ), np.float64)),
        "quality": fetch(
            lambda a, b: (quality.psnr(a, b),) + quality.ssim_msssim(a, b),
            q_r, q_d,
        ),
        "xpsnr": fetch(xpsnr_block_stats, y_r, y_d, prev),
        "vif": vif_scores(fetch(vif_scale_stats, y_rf, y_df)),
        "adm": adm_score(fetch(adm_stats, y_rf, y_df), h, w),
        "motion_blur": fetch(integer_blur, y_r),
        "vif_integer": [
            fetch(integer_vif_scale_planes, y_r[i], y_d[i])
            for i in range(len(refs))
        ],
        "adm_integer": [
            fetch(integer_adm_levels, y_r[i], y_d[i])
            for i in range(len(refs))
        ],
    }
    return out


def _max_abs(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    d = np.abs(a - b)
    both_inf = np.isinf(a) & np.isinf(b) & (np.sign(a) == np.sign(b))
    return float(np.where(both_inf, 0.0, d).max())


def _planes_delta(dev: list[dict], ora: list[dict]) -> float:
    """Largest difference over matching keys of per-level plane dicts."""
    worst = 0.0
    if len(dev) != len(ora):
        return float("inf")
    for d, o in zip(dev, ora):
        for key in o:
            if key in d:
                worst = max(worst, _max_abs(d[key], o[key]))
    return worst


def compare(refs, diss, oracles: dict) -> list[Row]:
    """Run every family on the device and compare with the oracle futures
    from :func:`submit_oracles`; one row per family."""
    dev = _device_outputs(
        refs, diss, oracles["lin_ref"], oracles["lin_dis"],
        oracles["q_ref"], oracles["q_dis"],
    )
    n = len(refs)
    ora_s2 = [f.result() for f in oracles["ssimulacra2"]]
    ora_iir = [f.result() for f in oracles["ssimulacra2_iir"]]
    ora_q = [f.result() for f in oracles["quality"]]
    ora_x = [f.result() for f in oracles["xpsnr"]]
    ora_v = [f.result() for f in oracles["vmaf"]]
    ora_blur = [f.result() for f in oracles["motion_blur"]]

    deltas = {
        "conversion": _max_abs(dev["conversion"], np.stack(oracles["lin_ref"])),
        "ssimulacra2": _max_abs(dev["ssimulacra2"], ora_s2),
        "ssimulacra2_iir": _max_abs(dev["ssimulacra2_iir"], ora_iir),
    }
    psnr, ssim, msssim = dev["quality"]
    deltas["psnr"] = _max_abs(psnr, [o["psnr"] for o in ora_q])
    deltas["ssim"] = _max_abs(ssim, [o["ssim"] for o in ora_q])
    deltas["msssim"] = _max_abs(msssim, [o["msssim"] for o in ora_q])
    deltas["xpsnr_stats"] = max(
        _max_abs(dev["xpsnr"][k][i], ora_x[i][k])
        for i in range(n)
        for k in ("sse", "sact", "tact")
    )
    deltas["vif"] = max(
        _max_abs(dev["vif"][k][i], ora_v[i]["vif"][k])
        for i in range(n)
        for k in ora_v[i]["vif"]
    )
    deltas["adm"] = max(
        _max_abs(dev["adm"][k][i], ora_v[i]["adm"][k])
        for i in range(n)
        for k in ora_v[i]["adm"]
    )
    sad_dev = np.abs(
        dev["motion_blur"][1:].astype(np.int64)
        - dev["motion_blur"][:-1].astype(np.int64)
    ).sum(axis=(-2, -1))
    sad_ora = [
        np.abs(b.astype(np.int64) - a.astype(np.int64)).sum()
        for a, b in zip(ora_blur[:-1], ora_blur[1:])
    ]
    deltas["motion"] = max(
        _max_abs(dev["motion_blur"], np.stack(ora_blur)),
        _max_abs(sad_dev, sad_ora) if n > 1 else 0.0,
    )
    deltas["vif_integer"] = max(
        _planes_delta(dev["vif_integer"][i], ora_v[i]["vif_integer"])
        for i in range(n)
    )
    deltas["adm_integer"] = max(
        _planes_delta(dev["adm_integer"][i], ora_v[i]["adm_integer"])
        for i in range(n)
    )
    return [Row(k, deltas[k], BUDGETS[k]) for k in BUDGETS]


def run_parity(
    seed: int, n: int, height: int, width: int,
    executor: Executor | None = None,
) -> list[Row]:
    """Synthetic frames from ``seed`` through every family and its oracle."""
    refs, diss = synthetic_clip(seed, n, height, width)
    return compare(refs, diss, submit_oracles(refs, diss, executor))

