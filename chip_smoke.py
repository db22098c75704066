"""Smoke test of the metric pipeline on NVIDIA GPUs.

Drives the normal entry point, ``turbo_metrics_tpu.cli.main``, end to end
on seeded synthetic Y4M clips at real video sizes; compiles and sizes each
composition's step; and compares every metric family with its NumPy oracle
at 1080p (``turbo_metrics_tpu.parity``).

    python chip_smoke.py               # one GPU: compositions (a)-(c), parity
    python chip_smoke.py --four-cards  # (b) on a 4-GPU mesh vs one GPU

One process drives the card(s); the oracles run in worker processes that
never touch JAX's GPU backend.  Exits 0 only when every phase passed, and
its last stdout line is then
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Without a GPU it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import statistics
import sys
import tempfile
import time
from dataclasses import dataclass

SEED = 20261016
STEADY_ITERS = 5


@dataclass(frozen=True)
class Composition:
    key: str
    title: str
    width: int
    height: int
    depth: int
    metrics: tuple[str, ...]
    frames: int
    color_args: tuple[str, ...] = ()


# The BASELINE.json configurations at their published sizes.
COMPOSITIONS = (
    Composition("a", "1080p 8-bit SSIMULACRA2", 1920, 1080, 8,
                ("ssimulacra2",), 24),
    Composition("b", "1080p 8-bit all families", 1920, 1080, 8,
                ("psnr", "ssim", "msssim", "ssimulacra2", "xpsnr", "vmaf"), 16),
    Composition("c", "4K 10-bit BT.2020/PQ XPSNR", 3840, 2160, 10,
                ("xpsnr",), 8,
                ("--color-matrix", "bt2020", "--color-transfer", "pq")),
)
PARITY_PAIRS = 2
PARITY_HW = (1080, 1920)

# Where each per-frame score of the distorted synthetic clips must lie
# (closed intervals); motion is 0 on the first frame by definition.
SCORE_RANGES = {
    "ssimulacra2": (0.0, 100.0),
    "psnr": (20.0, 80.0),
    "ssim": (0.0, 1.0),
    "msssim": (0.0, 1.0),
    "xpsnr": (20.0, 100.0),
    "vmaf_motion": (0.0, 255.0),
    **{f"vmaf_vif{s}": (0.0, 1.0) for s in ("", "_scale0", "_scale1", "_scale2", "_scale3")},
    **{f"vmaf_adm{s}": (0.0, 1.0) for s in ("", "_scale0", "_scale1", "_scale2", "_scale3")},
}
# What an identical pair must score.
IDENTICAL = {"ssimulacra2": 100.0, "psnr": math.inf, "xpsnr": math.inf}
# Largest per-frame |mesh - single card| accepted in the four-card phase:
# the same per-frame program at another per-device batch, so only f32
# reduction order may differ; integer-derived scores must be exact.
MESH_TOLERANCE = {
    "ssimulacra2": 1e-3, "psnr": 1e-4, "ssim": 1e-5, "msssim": 1e-5,
    "xpsnr": 0.0, "vmaf_motion": 0.0,
}
MESH_DEFAULT_TOLERANCE = 1e-5  # vif/adm scores


class PhaseError(RuntimeError):
    pass


def say(msg: str) -> None:
    print(msg, flush=True)


def _worker_init() -> None:
    # Oracle workers are NumPy-only; keep any JAX import there off the card.
    os.environ["JAX_PLATFORMS"] = "cpu"


def write_clip(comp: Composition, tmp: str) -> tuple[str, str]:
    from turbo_metrics_tpu.io.y4m import write_y4m
    from turbo_metrics_tpu.parity import synthetic_clip

    refs, diss = synthetic_clip(
        SEED, comp.frames, comp.height, comp.width, depth=comp.depth
    )
    paths = []
    for name, frames in (("ref", refs), ("dis", diss)):
        path = os.path.join(tmp, f"{comp.key}_{name}.y4m")
        write_y4m(path, frames, comp.width, comp.height, depth=comp.depth)
        paths.append(path)
    return paths[0], paths[1]


def run_cli(argv: list[str]) -> tuple[dict, float]:
    """cli.main with --output json; returns (parsed stdout, seconds)."""
    from turbo_metrics_tpu.cli import main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv + ["--output", "json", "--no-progress"])
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise PhaseError(f"cli.main{argv} returned {rc}")
    return json.loads(buf.getvalue()), seconds


def check_scores(comp: Composition, out: dict) -> None:
    if out["frame_count"] != comp.frames:
        raise PhaseError(
            f"({comp.key}) frame_count {out['frame_count']} != {comp.frames}"
        )
    for name, agg in out.items():
        if name == "frame_count":
            continue
        scores = agg["scores"]
        lo, hi = SCORE_RANGES[name]
        bad = [s for s in scores if not (math.isfinite(s) and lo <= s <= hi)]
        if len(scores) != comp.frames or bad:
            raise PhaseError(
                f"({comp.key}) {name}: {len(scores)} scores, out of "
                f"[{lo}, {hi}]: {bad[:4]}"
            )


def check_identical(comp: Composition, out: dict) -> None:
    for name, want in IDENTICAL.items():
        if name in out and any(s != want for s in out[name]["scores"]):
            raise PhaseError(
                f"({comp.key}) identical pair: {name} "
                f"{out[name]['scores'][:4]} != {want}"
            )


def _engine_for(comp: Composition, ref: str, dis: str, batch: int):
    """An engine plus one full batch of frames, opened the way the CLI
    opens them."""
    from turbo_metrics_tpu.engine import Metrics, TurboMetrics
    from turbo_metrics_tpu.io.frame_source import ColorOverrideSource
    from turbo_metrics_tpu.io.probe import create_source

    metrics = Metrics(**{m: True for m in comp.metrics})
    srcs = []
    for path in (ref, dis):
        src = create_source(path)
        if comp.color_args:
            opts = dict(zip(comp.color_args[::2], comp.color_args[1::2]))
            src = ColorOverrideSource(
                src, matrix=opts.get("--color-matrix"),
                transfer=opts.get("--color-transfer"),
            )
        srcs.append(src)
    frames = []
    for src in srcs:
        got = [src.get_frame() for _ in range(min(batch, comp.frames))]
        frames.append([got[i % len(got)] for i in range(batch)])
    ccs = [src.color_characteristics() for src in srcs]
    for src in srcs:
        src.close()
    eng = TurboMetrics(comp.width, comp.height, metrics, batch=batch)
    return eng, (frames[0], ccs[0], frames[1], ccs[1])


def size_step(comp: Composition, ref: str, dis: str) -> dict:
    """Cold and warm compile, memory analysis and steady step time of the
    composition's step at default_batch."""
    import jax

    from turbo_metrics_tpu.engine import default_batch

    batch = default_batch(comp.width, comp.height)
    eng, batch_args = _engine_for(comp, ref, dis, batch)
    step, args = eng.step_inputs(*batch_args)

    t0 = time.perf_counter()
    compiled = step.lower(*args).compile()
    cold = time.perf_counter() - t0
    jax.clear_caches()  # the second compile must come from the disk cache
    t0 = time.perf_counter()
    compiled = step.lower(*args).compile()
    warm = time.perf_counter() - t0

    mem = compiled.memory_analysis()
    peak = max(
        mem.peak_memory_in_bytes,
        mem.argument_size_in_bytes + mem.output_size_in_bytes
        + mem.temp_size_in_bytes - mem.alias_size_in_bytes,
    )
    stats = jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit", 0)

    dev_args = jax.device_put(args)
    jax.block_until_ready(compiled(*dev_args))
    times = []
    for _ in range(STEADY_ITERS):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*dev_args))
        times.append(time.perf_counter() - t0)
    step_s = statistics.median(times)
    res = {
        "batch": batch,
        "compile_cold_s": cold,
        "compile_warm_s": warm,
        "peak_bytes": peak,
        "bytes_limit": limit,
        "bytes_per_px_pair": peak / (batch * comp.width * comp.height),
        "temp_bytes": mem.temp_size_in_bytes,
        "argument_bytes": mem.argument_size_in_bytes,
        "step_s": step_s,
        "pairs_per_s": batch / step_s,
    }
    if limit and peak > limit:
        raise PhaseError(f"({comp.key}) step needs {peak} B > limit {limit} B")
    return res


def run_composition(comp: Composition, tmp: str) -> None:
    say(f"== ({comp.key}) {comp.title}: {comp.frames} pairs, "
        f"-m {' -m '.join(comp.metrics)} {' '.join(comp.color_args)}")
    ref, dis = write_clip(comp, tmp)
    sized = size_step(comp, ref, dis)
    say(
        f"({comp.key}) default batch {sized['batch']}: compile cold "
        f"{sized['compile_cold_s']:.2f} s, warm {sized['compile_warm_s']:.2f} s; "
        f"memory_analysis peak {sized['peak_bytes']} B "
        f"({sized['bytes_per_px_pair']:.1f} B per pixel-pair; temp "
        f"{sized['temp_bytes']} B, arguments {sized['argument_bytes']} B) "
        f"of bytes_limit {sized['bytes_limit']} B; steady step "
        f"{sized['step_s'] * 1e3:.3f} ms = {sized['pairs_per_s']:.1f} pairs/s "
        f"(device-resident inputs, median of {STEADY_ITERS})"
    )
    args = [*comp.color_args]
    for m in comp.metrics:
        args += ["-m", m]
    out, seconds = run_cli([ref, dis, *args])
    check_scores(comp, out)
    means = ", ".join(
        f"{k} {v['stats']['mean']:.4f}" for k, v in out.items() if k != "frame_count"
    )
    say(f"({comp.key}) cli.main: {out['frame_count']} pairs in {seconds:.3f} s "
        f"= {out['frame_count'] / seconds:.2f} pairs/s end to end "
        f"(decode, upload, disk-cached compile); means: {means}")
    same, _ = run_cli([ref, ref, *args, "--frames", "2"])
    check_identical(comp, same)
    say(f"({comp.key}) identical pair: " + ", ".join(
        f"{k} {same[k]['scores'][0]}" for k in IDENTICAL if k in same))


def four_cards(tmp: str) -> None:
    """Composition (b) through TurboMetrics(mesh=make_mesh(4)) and on one
    card, same frames, same batch; per-frame scores must agree."""
    from turbo_metrics_tpu.engine import Metrics, Options, TurboMetrics, default_batch
    from turbo_metrics_tpu.io.probe import create_source
    from turbo_metrics_tpu.parallel.mesh import make_mesh

    comp = COMPOSITIONS[1]
    ref, dis = write_clip(comp, tmp)
    mesh = make_mesh(4)
    metrics = Metrics(**{m: True for m in comp.metrics})
    batch = -(-min(default_batch(comp.width, comp.height) * 4,
                   comp.frames) // 4) * 4
    results = {}
    for name, m in (("mesh4", mesh), ("single", None)):
        eng = TurboMetrics(comp.width, comp.height, metrics, batch=batch, mesh=m)
        seconds = []
        for _ in range(2):  # the first pass compiles
            eng.reset_stream_state()
            t0 = time.perf_counter()
            res = eng.compute_all(create_source(ref), create_source(dis), Options())
            seconds.append(time.perf_counter() - t0)
        if res.frame_count != comp.frames:
            raise PhaseError(f"{name}: {res.frame_count} pairs")
        results[name] = res
        say(f"(b) {name}: {res.frame_count} pairs at batch {batch}: first "
            f"pass {seconds[0]:.3f} s (compiles), second {seconds[1]:.3f} s "
            f"= {res.frame_count / seconds[1]:.2f} pairs/s end to end")
    for name in ("psnr", "ssim", "msssim", "ssimulacra2", "xpsnr",
                 "vmaf_motion", "vmaf_vif", "vmaf_adm"):
        a = getattr(results["mesh4"], name).scores
        b = getattr(results["single"], name).scores
        d = max(0.0 if x == y else abs(x - y) for x, y in zip(a, b))
        tol = MESH_TOLERANCE.get(name, MESH_DEFAULT_TOLERANCE)
        say(f"(b) mesh4 vs single {name}: max|delta| {d:.3e} (tolerance {tol:g})")
        if not d <= tol:
            raise PhaseError(f"mesh4 vs single card: {name} delta {d}")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only composition (b) on a 4-GPU mesh vs one GPU")
    args = ap.parse_args(argv)

    import jax

    from turbo_metrics_tpu.utils.compile_cache import enable_compilation_cache
    from turbo_metrics_tpu.utils.device import (
        card_power_line,
        device_record,
        require_gpu,
    )

    devices = require_gpu()
    say(card_power_line())
    say(f"jax {jax.__version__} devices: {devices}")
    say(f"compilation cache: {enable_compilation_cache()}")

    with tempfile.TemporaryDirectory() as tmp:
        if args.four_cards:
            if len(devices) < 4:
                raise PhaseError(f"--four-cards needs 4 GPUs, found {len(devices)}")
            four_cards(tmp)
            devices = devices[:4]
        else:
            one_card(tmp)
            devices = devices[:1]
    print(json.dumps({"ok": True, "device": device_record(devices)}), flush=True)
    return 0


def one_card(tmp: str) -> None:
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from turbo_metrics_tpu.parity import compare, submit_oracles, synthetic_clip

    workers = max(1, min(6, (os.cpu_count() or 2) - 2))
    with ProcessPoolExecutor(
        max_workers=workers,
        mp_context=multiprocessing.get_context("spawn"),
        initializer=_worker_init,
    ) as pool:
        # The 1080p oracles are slow NumPy; they run while the card works.
        t0 = time.perf_counter()
        refs, diss = synthetic_clip(SEED + 1, PARITY_PAIRS, *PARITY_HW)
        oracles = submit_oracles(refs, diss, pool)
        for comp in COMPOSITIONS:
            run_composition(comp, tmp)
        say(f"== parity: {PARITY_PAIRS} pairs at {PARITY_HW[1]}x{PARITY_HW[0]}, "
            f"device vs refimpl oracles ({workers} oracle workers)")
        rows = compare(refs, diss, oracles)
        for row in rows:
            say(row.line())
        say(f"parity phase {time.perf_counter() - t0:.1f} s wall (overlapped)")
    failed = [r.family for r in rows if not r.ok]
    if failed:
        raise PhaseError(f"parity budget exceeded: {failed}")


if __name__ == "__main__":
    sys.exit(main())
