"""The pipeline engine: batches frames, runs one XLA program per batch.

A redesign of TurboMetrics (turbo-metrics/src/lib.rs:188-434).  Where the
reference juggles 5 CUDA streams and a CUDA graph per frame pair, this
engine converts both frames to linear RGB and computes every requested
metric inside a single jitted program over a whole batch of frame pairs —
XLA is the graph and the scheduler.  Only per-frame scalars come back to the
host; the 108-weight SSIMULACRA2 post-processing runs on host in f64.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from turbo_metrics_tpu.color.characteristics import (
    ColorCharacteristics,
    matrix_name,
    transfer_name,
)
from turbo_metrics_tpu.io.frame_source import FrameSource, RawFrame
from turbo_metrics_tpu.models.ssimulacra2 import ssimulacra2_subscores
from turbo_metrics_tpu.models.ssimulacra2_score import postprocess_score
from turbo_metrics_tpu.ops import colorspace, quality
from turbo_metrics_tpu.ops.downscale import scale_dims

log = logging.getLogger("turbo_metrics_tpu")


@dataclass
class Metrics:
    """Metric selection (turbo-metrics/src/lib.rs:27-37, extended with XPSNR,
    which the reference has in-tree but never wired to its CLI)."""

    psnr: bool = False
    ssim: bool = False
    msssim: bool = False
    ssimulacra2: bool = False
    xpsnr: bool = False
    vmaf: bool = False  # VMAF features (motion, vif, adm) + fused score
    # Set when a fusion model is loaded (vmaf_v0.6.1.json et al.); gates the
    # 'vmaf' output column.  Without a model only elementary features emit.
    vmaf_fused: bool = False

    def any(self) -> bool:
        return (
            self.psnr
            or self.ssim
            or self.msssim
            or self.ssimulacra2
            or self.xpsnr
            or self.vmaf
        )


@dataclass
class Options:
    """Frame-subsetting options (turbo-metrics/src/lib.rs:39-54)."""

    every: int = 0
    skip: int = 0
    skip_ref: int = 0
    skip_dis: int = 0
    frames: int = 0


@dataclass
class FrameScores:
    psnr: Optional[float] = None
    ssim: Optional[float] = None
    msssim: Optional[float] = None
    ssimulacra2: Optional[float] = None
    xpsnr: Optional[float] = None
    vmaf: Optional[float] = None  # fused score (needs a model file)
    vmaf_motion: Optional[float] = None
    vmaf_vif: Optional[float] = None
    vmaf_vif_scale0: Optional[float] = None
    vmaf_vif_scale1: Optional[float] = None
    vmaf_vif_scale2: Optional[float] = None
    vmaf_vif_scale3: Optional[float] = None
    vmaf_adm: Optional[float] = None
    vmaf_adm_scale0: Optional[float] = None
    vmaf_adm_scale1: Optional[float] = None
    vmaf_adm_scale2: Optional[float] = None
    vmaf_adm_scale3: Optional[float] = None

    def to_dict(self) -> dict:
        return {k: v for k, v in self.__dict__.items() if v is not None}


@dataclass
class MetricAggregate:
    scores: list[float]
    stats: "Stats"


@dataclass
class MetricsResults:
    frame_count: int
    # Set when the run stopped because a source reconfigured mid-stream
    # (new (width, height) segment); the CLI rebuilds the engine and
    # continues, merging segment results (see merge_results).
    resolution_changed: Optional[tuple[int, int]] = None
    psnr: Optional[MetricAggregate] = None
    ssim: Optional[MetricAggregate] = None
    msssim: Optional[MetricAggregate] = None
    ssimulacra2: Optional[MetricAggregate] = None
    xpsnr: Optional[MetricAggregate] = None
    vmaf: Optional[MetricAggregate] = None
    vmaf_motion: Optional[MetricAggregate] = None
    vmaf_vif: Optional[MetricAggregate] = None
    vmaf_vif_scale0: Optional[MetricAggregate] = None
    vmaf_vif_scale1: Optional[MetricAggregate] = None
    vmaf_vif_scale2: Optional[MetricAggregate] = None
    vmaf_vif_scale3: Optional[MetricAggregate] = None
    vmaf_adm: Optional[MetricAggregate] = None
    vmaf_adm_scale0: Optional[MetricAggregate] = None
    vmaf_adm_scale1: Optional[MetricAggregate] = None
    vmaf_adm_scale2: Optional[MetricAggregate] = None
    vmaf_adm_scale3: Optional[MetricAggregate] = None


METRIC_NAMES = (
    "psnr", "ssim", "msssim", "ssimulacra2", "xpsnr",
    "vmaf", "vmaf_motion", "vmaf_vif",
    "vmaf_vif_scale0", "vmaf_vif_scale1", "vmaf_vif_scale2", "vmaf_vif_scale3",
    "vmaf_adm",
    "vmaf_adm_scale0", "vmaf_adm_scale1", "vmaf_adm_scale2", "vmaf_adm_scale3",
)


def metric_enabled(metrics: Metrics, name: str) -> bool:
    """Whether an output column/field is active for this metric selection."""
    if name == "vmaf":
        return metrics.vmaf and metrics.vmaf_fused
    if name.startswith("vmaf_"):
        return metrics.vmaf
    return getattr(metrics, name)


from turbo_metrics_tpu.utils.stats import Stats  # noqa: E402  (dataclass ref above)


def _aggregate(scores: Optional[list[float]]) -> Optional[MetricAggregate]:
    if scores is None:
        return None
    return MetricAggregate(scores=scores, stats=Stats.compute(scores))


def merge_results(parts: list[MetricsResults]) -> MetricsResults:
    """Concatenate per-segment results (mid-stream reconfiguration) into one
    MetricsResults with stats recomputed over the full stream."""
    if len(parts) == 1:
        return parts[0]
    merged = MetricsResults(frame_count=sum(p.frame_count for p in parts))
    merged.resolution_changed = parts[-1].resolution_changed
    for name in METRIC_NAMES:
        scores: list[float] = []
        any_set = False
        for p in parts:
            agg = getattr(p, name)
            if agg is not None:
                any_set = True
                scores.extend(agg.scores)
        if any_set:
            setattr(merged, name, _aggregate(scores))
    return merged


# --------------------------------------------------------------------------
# Conversion specs (static jit arguments)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ConvertSpec:
    """Static description of an input frame format -> linear RGB conversion."""

    kind: str  # 'yuv420' (any planar YUV; see chroma) | 'rgb'
    depth: int
    matrix: str
    transfer: str
    full_range: bool
    chroma: int = 420  # 420 | 422 | 444 subsampling of the uv plane

    @classmethod
    def for_frame(
        cls, frame: RawFrame, cc: ColorCharacteristics, crange: str
    ) -> "ConvertSpec":
        if frame.kind == "rgb":
            # Packed RGB sources are gamma sRGB, like the reference's image
            # path (turbo-metrics/src/color.rs:112-114).
            return cls("rgb", frame.depth, "identity", "srgb", True)
        return cls(
            "yuv420",
            frame.depth,
            matrix_name(cc),
            transfer_name(cc),
            crange == "full",
            frame.chroma,
        )


def _convert_to_linear(spec: ConvertSpec, arrays: tuple[jax.Array, ...]) -> jax.Array:
    """Dispatch on static spec (turbo-metrics/src/color.rs:96-116).

    Full-chroma 4:2:2/4:4:4 converts on the real chroma grid, which beats
    the reference: it decimates to NVDEC's 4:2:0 surfaces."""
    if spec.kind == "yuv420":
        y, uv = arrays
        return colorspace.yuv420_to_linear_rgb(
            y,
            uv,
            depth=spec.depth,
            matrix=spec.matrix,
            transfer=spec.transfer,
            full_range=spec.full_range,
            chroma=spec.chroma,
        )
    (rgb,) = arrays  # (B, H, W, 3) -> (B, 3, H, W)
    rgb = jnp.transpose(rgb, (0, 3, 1, 2))
    if spec.transfer == "linear":
        return rgb.astype(jnp.float32)
    return colorspace.srgb_to_linear(rgb, depth=spec.depth)


def _align_luma_depth(y: jax.Array, from_depth: int, to_depth: int) -> jax.Array:
    """Rescale integer luma code values between bit depths (left/right shift,
    the standard video code-value mapping).  XPSNR and the VMAF features
    compare raw code values, so heterogeneous ref/dis depths (e.g. 8-bit ref
    vs 10-bit dis) must be brought to a common depth first — the reference
    never hits this case because NVDEC surfaces share one format."""
    if from_depth == to_depth:
        return y
    y = y.astype(jnp.int32)
    if to_depth > from_depth:
        return y << (to_depth - from_depth)
    return y >> (from_depth - to_depth)


def _luma_code(spec: ConvertSpec, arrays: tuple[jax.Array, ...]) -> jax.Array:
    """Integer luma code values (B, H, W) for XPSNR.

    YUV sources use the decoded Y plane directly (as the reference does);
    RGB sources derive gamma-domain luma with BT.709 weights.
    """
    if spec.kind == "yuv420":
        return arrays[0]
    rgb = arrays[0].astype(jnp.float32)
    kr, kb = colorspace.MATRIX_KR_KB["bt709"]
    kg = 1.0 - kr - kb
    y = (
        np.float32(kr) * rgb[..., 0]
        + np.float32(kg) * rgb[..., 1]
        + np.float32(kb) * rgb[..., 2]
    )
    return jnp.round(y).astype(jnp.int32)


def _luma_metric_outs(
    out: dict,
    metrics: "Metrics",
    spec_ref: ConvertSpec,
    spec_dis: ConvertSpec,
    ref_arrays,
    dis_arrays,
    aux,
    *,
    vmaf_integer: bool,
    axis_name,
) -> dict:
    """XPSNR + VMAF-feature outputs (the luma-code consumers)."""
    if metrics.xpsnr:
        from turbo_metrics_tpu.ops.xpsnr_ops import xpsnr_block_stats

        y_ref = _luma_code(spec_ref, ref_arrays)
        y_dis = _align_luma_depth(
            _luma_code(spec_dis, dis_arrays),
            spec_dis.depth,
            spec_ref.depth,
        )
        y_prev = _luma_code(spec_ref, aux["prev_ref"])
        out["xpsnr_stats"] = xpsnr_block_stats(y_ref, y_dis, y_prev)
    if metrics.vmaf:
        from turbo_metrics_tpu.ops.adm import adm_stats
        from turbo_metrics_tpu.ops.vif import vif_scale_stats
        from turbo_metrics_tpu.ops.vmaf_motion import integer_blur

        y_ref = _luma_code(spec_ref, ref_arrays)
        y_dis = _align_luma_depth(
            _luma_code(spec_dis, dis_arrays),
            spec_dis.depth,
            spec_ref.depth,
        )
        if vmaf_integer:
            # Fixed-point path (libvmaf default conventions):
            # integer code values in, depth handled internally.
            out["vif_stats"] = vif_scale_stats(
                y_ref, y_dis, integer=True, depth=spec_ref.depth
            )
            out["adm_stats"] = adm_stats(
                y_ref, y_dis, integer=True, depth=spec_ref.depth
            )
        else:
            # VIF runs on luma in 8-bit units.
            scale8 = np.float32(255.0 / ((1 << spec_ref.depth) - 1))
            out["vif_stats"] = vif_scale_stats(
                y_ref.astype(jnp.float32) * scale8,
                y_dis.astype(jnp.float32) * scale8,
            )
            out["adm_stats"] = adm_stats(
                y_ref.astype(jnp.float32) * scale8,
                y_dis.astype(jnp.float32) * scale8,
            )
        blurred = integer_blur(y_ref, depth=spec_ref.depth)
        prev_blur = aux["vmaf_prev_blur"]
        if axis_name is not None:
            # Sharded batch: each shard's first frame diffs against the
            # PREVIOUS shard's last blurred frame — one ppermute;
            # shard 0 uses the streaming state (the previous batch's
            # global last frame).
            last32 = blurred[-1].astype(jnp.int32)
            n = jax.lax.axis_size(axis_name)
            left_last = jax.lax.ppermute(
                last32, axis_name, [(i, i + 1) for i in range(n - 1)]
            )
            idx = jax.lax.axis_index(axis_name)
            prev0 = jnp.where(
                idx == 0, prev_blur.astype(jnp.int32), left_last
            )
            prev_seq = jnp.concatenate(
                [prev0[None], blurred[:-1].astype(jnp.int32)], axis=0
            )
        else:
            prev_seq = jnp.concatenate(
                [prev_blur[None], blurred[:-1]], axis=0
            ).astype(jnp.int32)
        diff = jnp.abs(blurred.astype(jnp.int32) - prev_seq).astype(jnp.uint32)
        out["vmaf_sad_rows"] = diff.sum(axis=-1, dtype=jnp.uint32)
        # (1, H, W) so sharded runs concatenate per-shard lasts; the host
        # takes the global last ([-1]).
        out["vmaf_last_blur"] = blurred[-1:]
    return out


class _VmafFuser:
    """Streams FrameScores through the fusion model with one frame of
    holdback: libvmaf's 'motion2' feature for frame i is
    min(motion[i], motion[i+1]), so a frame's fused score is only final once
    the next frame's motion is known (the last frame keeps its own motion,
    matching libvmaf's end-of-stream behaviour)."""

    def __init__(self, model):
        self.model = model
        self.pending: Optional[FrameScores] = None

    def push(self, s: FrameScores) -> Optional[FrameScores]:
        ready = None
        if self.pending is not None:
            self._fuse(self.pending, next_motion=s.vmaf_motion)
            ready = self.pending
        self.pending = s
        return ready

    def flush(self) -> Optional[FrameScores]:
        if self.pending is not None:
            self._fuse(self.pending, next_motion=None)
        ready, self.pending = self.pending, None
        return ready

    def _fuse(self, s: FrameScores, next_motion: Optional[float]) -> None:
        m = s.vmaf_motion
        m2 = m if next_motion is None else min(m, next_motion)
        feats = {
            "adm2": s.vmaf_adm,
            "motion": m,
            "motion2": m2,
            "vif": s.vmaf_vif,
            **{f"vif_scale{k}": getattr(s, f"vmaf_vif_scale{k}") for k in range(4)},
            **{f"adm_scale{k}": getattr(s, f"vmaf_adm_scale{k}") for k in range(4)},
        }
        s.vmaf = self.model.predict_one(feats)


# --------------------------------------------------------------------------
# Engine
# --------------------------------------------------------------------------

class TurboMetrics:
    """Per-resolution metric engine; compiles one XLA program per
    (input format pair, batch size) and replays it for every batch."""

    def __init__(
        self,
        width: int,
        height: int,
        metrics: Metrics,
        *,
        batch: int | None = None,
        vmaf_model=None,
        mesh=None,
        vmaf_integer: bool = False,
    ):
        if not metrics.any():
            raise ValueError("at least one metric must be selected")
        self.width = int(width)
        self.height = int(height)
        self.metrics = metrics
        self.mesh = mesh  # jax.sharding.Mesh: shard frame batches over devices
        if mesh is not None:
            self._mesh_size = int(np.prod(mesh.devices.shape))
        self.batch = batch if batch is not None else default_batch(width, height)
        if mesh is not None and self.batch % self._mesh_size:
            # Round the batch up so every device gets equal frames per step.
            self.batch = -(-self.batch // self._mesh_size) * self._mesh_size
        self.num_scales = len(scale_dims(self.height, self.width))
        # Fixed-point VIF/ADM (libvmaf's default integer conventions;
        # ops/integer_vif.py, ops/integer_adm.py) instead of the float path.
        self.vmaf_integer = bool(vmaf_integer)
        self._step_cache: dict = {}
        self._prev_ref: Optional[np.ndarray] = None  # XPSNR temporal state
        self._vmaf_prev_blur: Optional[np.ndarray] = None  # motion state
        self.vmaf_model = vmaf_model  # models.vmaf_model.VmafModel or None
        if vmaf_model is not None:
            metrics.vmaf_fused = True

    def reset_stream_state(self) -> None:
        """Clear temporal state before scoring a new clip with this engine."""
        self._prev_ref = None
        self._vmaf_prev_blur = None

    # -- device program ----------------------------------------------------

    def _shard(self, step):
        """Wrap a step in shard_map over the frame axis (SURVEY.md section 5:
        pure data parallelism — scores gather as per-frame scalars; the one
        cross-device edge is VMAF motion's shard-boundary frame, a single
        ppermute)."""
        if self.mesh is None:
            return step
        from jax.sharding import PartitionSpec as P

        spec = P(self.mesh.axis_names[0])
        aux_spec: dict = {}
        if self.metrics.xpsnr:
            aux_spec["prev_ref"] = spec  # (B, ...) host-built, batch-sharded
        if self.metrics.vmaf:
            aux_spec["vmaf_prev_blur"] = P()  # (H, W): replicated
        return jax.shard_map(
            step,
            mesh=self.mesh,
            in_specs=(spec, spec, aux_spec),
            out_specs=spec,
        )

    def _get_step(self, spec_ref: ConvertSpec, spec_dis: ConvertSpec):
        """The jitted step for one input-format pair (compiled on first call
        at each batch shape)."""
        key = (spec_ref, spec_dis)
        fn = self._step_cache.get(key)
        if fn is not None:
            return fn
        metrics = self.metrics
        num_scales = self.num_scales
        vmaf_integer = self.vmaf_integer
        axis_name = self.mesh.axis_names[0] if self.mesh is not None else None

        def step(ref_arrays, dis_arrays, aux):
            lin_ref = _convert_to_linear(spec_ref, ref_arrays)
            lin_dis = _convert_to_linear(spec_dis, dis_arrays)
            out = {}
            if metrics.psnr or metrics.ssim or metrics.msssim:
                # Quantize to 8-bit code values, like the reference's
                # f32_to_8bit pass before NPP (lib.rs:296-305).
                q_ref = jnp.clip(jnp.round(lin_ref * 255.0), 0.0, 255.0)
                q_dis = jnp.clip(jnp.round(lin_dis * 255.0), 0.0, 255.0)
                if metrics.psnr:
                    out["psnr"] = quality.psnr(q_ref, q_dis)
                if metrics.ssim and metrics.msssim:
                    # One shared level-0 windowed pass (MS-SSIM's level 0
                    # IS the SSIM index; ops/quality.py).
                    out["ssim"], out["msssim"] = quality.ssim_msssim(
                        q_ref, q_dis
                    )
                elif metrics.ssim:
                    out["ssim"] = quality.ssim(q_ref, q_dis)
                elif metrics.msssim:
                    out["msssim"] = quality.msssim(q_ref, q_dis)
            if metrics.ssimulacra2:
                out["ssimulacra2_subscores"] = ssimulacra2_subscores(
                    lin_ref, lin_dis, num_scales=num_scales
                )
            _luma_metric_outs(
                out, metrics, spec_ref, spec_dis,
                ref_arrays, dis_arrays, aux,
                vmaf_integer=vmaf_integer, axis_name=axis_name,
            )
            return out

        fn = jax.jit(self._shard(step))
        self._step_cache[key] = fn
        return fn

    def step_inputs(
        self,
        ref_frames: list[RawFrame],
        cc_ref: tuple[ColorCharacteristics, str],
        dis_frames: list[RawFrame],
        cc_dis: tuple[ColorCharacteristics, str],
    ):
        """(step, args) for one full batch, without updating stream state:
        ``step.lower(*args).compile()`` gives the compiled program that
        compute_frames runs, for compile timing and memory analysis."""
        spec_ref = ConvertSpec.for_frame(ref_frames[0], *cc_ref)
        spec_dis = ConvertSpec.for_frame(dis_frames[0], *cc_dis)
        ref_arrays, _ = self._stack(ref_frames)
        dis_arrays, _ = self._stack(dis_frames)
        aux: dict = {}
        if self.metrics.xpsnr:
            aux["prev_ref"] = ref_arrays
        if self.metrics.vmaf:
            aux["vmaf_prev_blur"] = np.zeros(
                (self.height, self.width), np.uint16
            )
        step = self._get_step(spec_ref, spec_dis)
        return step, (ref_arrays, dis_arrays, aux)

    # -- host batching -----------------------------------------------------

    def _stack(self, frames: list[RawFrame]) -> tuple[tuple[np.ndarray, ...], RawFrame]:
        f0 = frames[0]
        if f0.kind == "yuv420":
            y = np.stack([f.y for f in frames])
            uv = np.stack([f.uv for f in frames])
            return (y, uv), f0
        rgb = np.stack([f.rgb for f in frames])
        return (rgb,), f0

    def compute_frames(
        self,
        ref_frames: list[RawFrame],
        cc_ref: tuple[ColorCharacteristics, str],
        dis_frames: list[RawFrame],
        cc_dis: tuple[ColorCharacteristics, str],
    ) -> list[FrameScores]:
        """Compute all selected metrics for a batch of frame pairs."""
        assert len(ref_frames) == len(dis_frames) and ref_frames
        n = len(ref_frames)
        # Pad partial batches to the full batch size by repeating the last
        # frame: one compiled program per input spec instead of one per batch
        # size (XLA compiles take seconds-to-minutes at 1080p).  Streaming
        # state stays correct because the padding *is* the last real frame;
        # padded scores are sliced off below.
        if n < self.batch:
            pad = self.batch - n
            ref_frames = ref_frames + [ref_frames[-1]] * pad
            dis_frames = dis_frames + [dis_frames[-1]] * pad
        f_ref, f_dis = ref_frames[0], dis_frames[0]
        spec_ref = ConvertSpec.for_frame(f_ref, *cc_ref)
        spec_dis = ConvertSpec.for_frame(f_dis, *cc_dis)
        step = self._get_step(spec_ref, spec_dis)
        ref_arrays, _ = self._stack(ref_frames)
        dis_arrays, _ = self._stack(dis_frames)

        # Auxiliary streaming state: previous reference frame (XPSNR temporal
        # activity; the stream's first frame sees itself) and previous blurred
        # luma (VMAF motion).  Built only for the metrics that need it — jit
        # arguments are uploaded whether the traced fn uses them or not.
        aux: dict = {}
        if self.metrics.xpsnr:
            lead = ref_arrays[0]
            prev0 = self._prev_ref if self._prev_ref is not None else lead[0:1]
            prev_lead = np.concatenate([prev0, lead[:-1]], axis=0)
            aux["prev_ref"] = (prev_lead,) + tuple(a for a in ref_arrays[1:])
            self._prev_ref = np.array(lead[-1:])
        vmaf_first = False
        if self.metrics.vmaf:
            if self._vmaf_prev_blur is None:
                vmaf_first = True
                from turbo_metrics_tpu.ops.vmaf_motion import integer_blur

                y0 = np.asarray(
                    jax.jit(
                        lambda a: _luma_code(spec_ref, a)[0:1]
                    )(ref_arrays)
                )
                self._vmaf_prev_blur = np.asarray(
                    jax.jit(
                        lambda y: integer_blur(y, depth=spec_ref.depth)
                    )(y0)
                )[0]
            aux["vmaf_prev_blur"] = self._vmaf_prev_blur

        out = step(ref_arrays, dis_arrays, aux)

        scores = [FrameScores() for _ in range(n)]
        for name in ("psnr", "ssim", "msssim"):
            if name in out:
                vals = np.asarray(out[name], dtype=np.float64)
                for i in range(n):
                    setattr(scores[i], name, float(vals[i]))
        if "ssimulacra2_subscores" in out:
            vals = np.asarray(out["ssimulacra2_subscores"], dtype=np.float64)
            s2 = postprocess_score(vals)
            for i in range(n):
                scores[i].ssimulacra2 = float(s2[i])
        if "vif_stats" in out:
            from turbo_metrics_tpu.ops.adm import adm_score
            from turbo_metrics_tpu.ops.vif import vif_scores
            from turbo_metrics_tpu.ops.vmaf_motion import motion_score

            adm = adm_score(
                np.asarray(out["adm_stats"]), self.height, self.width
            )
            vs = vif_scores(np.asarray(out["vif_stats"]))
            sads = np.asarray(out["vmaf_sad_rows"], dtype=np.int64).sum(axis=-1)
            self._vmaf_prev_blur = np.asarray(out["vmaf_last_blur"])[-1]
            for i in range(n):
                scores[i].vmaf_vif = float(vs["vif"][i])
                for k in range(4):
                    setattr(
                        scores[i], f"vmaf_vif_scale{k}", float(vs[f"vif_scale{k}"][i])
                    )
                scores[i].vmaf_adm = float(adm["adm2"][i])
                for k in range(4):
                    setattr(
                        scores[i],
                        f"vmaf_adm_scale{k}",
                        float(adm[f"adm_scale{k}"][i]),
                    )
                scores[i].vmaf_motion = motion_score(
                    int(sads[i]), self.width, self.height, depth=f_ref.depth
                )
            if vmaf_first:
                scores[0].vmaf_motion = 0.0
        if "xpsnr_stats" in out:
            from turbo_metrics_tpu.ops.xpsnr_ops import xpsnr_db, xpsnr_weights

            stats = {k: np.asarray(v) for k, v in out["xpsnr_stats"].items()}
            depth = f_ref.depth if f_ref.kind == "yuv420" else 8
            for i in range(n):
                wsse, _ = xpsnr_weights(
                    stats["sse"][i], stats["sact"][i], stats["tact"][i],
                    width=self.width, height=self.height, depth=depth,
                )
                scores[i].xpsnr = xpsnr_db(
                    wsse, width=self.width, height=self.height, depth=depth
                )
        return scores

    def compute_one(
        self,
        ref_frame: RawFrame,
        cc_ref: tuple[ColorCharacteristics, str],
        dis_frame: RawFrame,
        cc_dis: tuple[ColorCharacteristics, str],
    ) -> FrameScores:
        """Single frame-pair API (turbo-metrics/src/lib.rs:268-360).

        With a fusion model loaded the score uses motion2 == motion (no
        lookahead exists for a single pair)."""
        s = self.compute_frames([ref_frame], cc_ref, [dis_frame], cc_dis)[0]
        if self.vmaf_model is not None and s.vmaf_motion is not None:
            _VmafFuser(self.vmaf_model)._fuse(s, next_motion=None)
        return s

    # -- full drive loop ----------------------------------------------------

    def compute_all(
        self,
        frames_ref: FrameSource,
        frames_dis: FrameSource,
        opts: Options = Options(),
        on_frame: Optional[Callable[[FrameScores], None]] = None,
        *,
        prefetch: bool = True,
    ) -> MetricsResults:
        """Drive both sources to exhaustion (turbo-metrics/src/lib.rs:362-433).

        Frame subsetting (every/skip/frames) matches the reference's loop
        semantics exactly.  Pairs are accumulated into batches of
        ``self.batch`` before dispatch; ``on_frame`` is called per frame pair
        in order.  With ``prefetch`` a background thread decodes the next
        batch while the device crunches the current one (the analog of the
        reference's stream-ordered decode/compute overlap).
        """
        if (frames_ref.width, frames_ref.height) != (frames_dis.width, frames_dis.height):
            raise ValueError("Reference and distorted are not the same size")

        cc_ref = frames_ref.color_characteristics()
        cc_dis = frames_dis.color_characteristics()

        m = self.metrics
        acc: dict[str, Optional[list[float]]] = {
            name: ([] if metric_enabled(m, name) else None)
            for name in METRIC_NAMES
        }

        frames_ref.skip_frames(opts.skip_ref + opts.skip)
        frames_dis.skip_frames(opts.skip_dis + opts.skip)

        compute_count = 0
        fuser = (
            _VmafFuser(self.vmaf_model)
            if (m.vmaf and self.vmaf_model is not None)
            else None
        )

        def emit(s: FrameScores) -> None:
            for name, lst in acc.items():
                v = getattr(s, name)
                if lst is not None and v is not None:
                    lst.append(v)
            if on_frame is not None:
                on_frame(s)

        def consume(batch_ref: list[RawFrame], batch_dis: list[RawFrame]):
            nonlocal compute_count
            batch_scores = self.compute_frames(batch_ref, cc_ref, batch_dis, cc_dis)
            for s in batch_scores:
                if fuser is not None:
                    ready = fuser.push(s)
                    if ready is not None:
                        emit(ready)
                else:
                    emit(s)
            compute_count += len(batch_scores)

        from turbo_metrics_tpu.io.frame_source import ResolutionChanged

        res_change: Optional[tuple[int, int]] = None
        if prefetch:
            from turbo_metrics_tpu.parallel.streaming import FramePrefetcher

            batches = FramePrefetcher(
                frames_ref,
                frames_dis,
                batch=self.batch,
                every=opts.every,
                frames=opts.frames,
            )
            try:
                for batch_ref, batch_dis in batches:
                    consume(batch_ref, batch_dis)
            except ResolutionChanged as e:
                res_change = (e.width, e.height)
        else:
            pend_ref: list[RawFrame] = []
            pend_dis: list[RawFrame] = []
            decode_count = 0
            while True:
                fref = fdis = None
                try:
                    fref = frames_ref.get_frame()
                    fdis = frames_dis.get_frame()
                except ResolutionChanged as e:
                    # Keep the pair lockstep: return an already-fetched mate
                    # so the new segment starts with matched frames.
                    if fref is not None:
                        frames_ref.push_back(fref)
                    res_change = (e.width, e.height)
                    break
                if fref is None or fdis is None:
                    break
                if opts.every > 1 and decode_count != 0 and decode_count % opts.every != 0:
                    decode_count += 1
                    continue
                if opts.frames > 0 and decode_count >= opts.frames:
                    break
                decode_count += 1
                pend_ref.append(fref)
                pend_dis.append(fdis)
                if len(pend_ref) >= self.batch:
                    consume(pend_ref, pend_dis)
                    pend_ref, pend_dis = [], []
            if pend_ref:
                consume(pend_ref, pend_dis)

        if fuser is not None:
            ready = fuser.flush()
            if ready is not None:
                emit(ready)

        return MetricsResults(
            frame_count=compute_count,
            resolution_changed=res_change,
            **{name: _aggregate(acc[name]) for name in METRIC_NAMES},
        )


# Device bytes one frame pair costs the step at its peak, per pixel: the
# argument + output + temp bytes of compiled.memory_analysis() divided by
# batch * width * height.  At 1080p on an H100 it measured 135.0 for
# SSIMULACRA2 alone and 136.2-137.1 for all families at batches 4-32: the
# SSIMULACRA2 scale-0 product stack sets the peak (PERF.md).
STEP_BYTES_PER_PX = 138
# The 1080p per-pair rate on an H100 stops rising at batch 8, for SSIMULACRA2
# alone and for all families (PERF.md batch ladder); a larger batch only
# adds latency and memory.
BATCH_CAP = 8
# Share of the device allocator's limit a step may plan for; the rest is
# headroom for the next batch's uploads, the VMAF first-frame program and
# fragmentation.
BUDGET_SHARE = 0.5
# Budget on a device that reports no allocator limit (the CPU backend).
HOST_BUDGET_BYTES = 4 << 30


def device_memory_budget() -> int:
    """Bytes a step may plan for on the default device."""
    stats = jax.devices()[0].memory_stats()
    if stats and stats.get("bytes_limit"):
        return int(stats["bytes_limit"] * BUDGET_SHARE)
    return HOST_BUDGET_BYTES


def default_batch(width: int, height: int) -> int:
    """Frame pairs per step: as many as fit the device budget at the
    measured bytes per pixel, up to the measured throughput cap."""
    per_pair = STEP_BYTES_PER_PX * width * height
    return int(np.clip(device_memory_budget() // max(per_pair, 1), 1, BATCH_CAP))
