"""End-to-end benchmark: demux + CPU decode + GPU metric on a real clip.

The reference's headline (669 fps / 277 Mpx/s on an RTX 4070, turbo-metrics-cli
README) is a decode-inclusive number (NVDEC H.262 ref vs AV1 dis at
720x576).  This measures the same thing for this framework on a real
encoded clip: frames stream host->device while the engine computes
SSIMULACRA2.

Uses an MPEG-2 transport stream (the reference's example ref codec; also the
cheapest decode), encoded once with OpenCV and decoded by the native libav
shim.  --workers N engages the seek-partitioned chunked decode pool
(parallel/decode_pool.py).  One process per card; fails when JAX finds no
GPU.

Prints one JSON line:
  {"metric": "ssimulacra2_1080p_e2e_fps", "value": ..., "unit": "fps",
   "vs_baseline": <Mpx/s vs the reference's 277.47>, "device": {...}}
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

BASELINE_MPXS = 277.47
H, W = 1080, 1920
NFRAMES = int(os.environ.get("TM_E2E_FRAMES", "96"))
CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".bench_cache")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def make_clip(
    path: str, *, seed: int, codec: str = "MPG2", w: int = None, h: int = None
) -> None:
    import cv2

    w = w or W
    h = h or H
    os.makedirs(CACHE, exist_ok=True)
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*codec), 25, (w, h))
    if not vw.isOpened():
        raise RuntimeError(f"encoder {codec} unavailable")
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (128 + 64 * np.sin(xx / 37.0) * np.cos(yy / 23.0)).astype(np.uint8)
    noise = rng.integers(0, 14, (h, w), dtype=np.uint8)
    for i in range(NFRAMES):
        img = np.empty((h, w, 3), np.uint8)
        plane = np.roll(base, 7 * i, axis=1)
        img[:, :, 0] = plane
        img[:, :, 1] = np.roll(plane, i, axis=0)
        img[:, :, 2] = plane ^ noise
        vw.write(img)
    vw.release()


def open_source(path: str, workers: int):
    from turbo_metrics_tpu.io.probe import create_source

    if workers > 1:
        from turbo_metrics_tpu.parallel.decode_pool import ChunkedVideoSource

        try:
            return ChunkedVideoSource(path, workers=workers)
        except ValueError:
            pass
    return create_source(path)


def main() -> int:
    workers = int(os.environ.get("TM_E2E_WORKERS", "1"))
    for a in sys.argv[1:]:
        if a.startswith("--workers="):
            workers = int(a.split("=", 1)[1])

    ref_path = os.path.join(CACHE, f"e2e_ref_{W}x{H}_{NFRAMES}.ts")
    dis_path = os.path.join(CACHE, f"e2e_dis_{W}x{H}_{NFRAMES}.ts")
    for path, seed in ((ref_path, 1), (dis_path, 2)):
        if not os.path.exists(path):
            t0 = time.perf_counter()
            make_clip(path, seed=seed)
            log(f"bench_e2e: encoded {path} in {time.perf_counter()-t0:.1f}s")

    # Decode-only rate (one stream) for context.
    t0 = time.perf_counter()
    src = open_source(ref_path, workers)
    ndec = 0
    while src.get_frame() is not None:
        ndec += 1
    dec_fps = ndec / (time.perf_counter() - t0)
    log(f"bench_e2e: decode-only {dec_fps:.1f} fps/stream ({ndec} frames, "
        f"workers={workers})")

    from turbo_metrics_tpu.engine import Metrics, Options, TurboMetrics
    from turbo_metrics_tpu.utils.compile_cache import enable_compilation_cache
    from turbo_metrics_tpu.utils.device import (
        card_power_line,
        device_record,
        require_gpu,
    )

    devices = require_gpu()
    enable_compilation_cache()

    src_r = open_source(ref_path, workers)
    src_d = open_source(dis_path, workers)
    eng = TurboMetrics(src_r.width, src_r.height, Metrics(ssimulacra2=True))
    # Warm the compile outside the timed region.
    t0 = time.perf_counter()
    eng.compute_all(src_r, src_d, Options(frames=eng.batch))
    log(f"bench_e2e: compile+first batch {time.perf_counter()-t0:.1f}s")
    eng.reset_stream_state()

    src_r = open_source(ref_path, workers)
    src_d = open_source(dis_path, workers)
    t0 = time.perf_counter()
    results = eng.compute_all(src_r, src_d)
    elapsed = time.perf_counter() - t0
    fps = results.frame_count / elapsed
    mpxs = fps * W * H / 1e6
    log(f"bench_e2e: end-to-end {fps:.1f} fps ({mpxs:.0f} Mpx/s), "
        f"{results.frame_count} pairs, ssimulacra2 mean "
        f"{results.ssimulacra2.stats.mean:.2f}")
    print(json.dumps({
        "metric": "ssimulacra2_1080p_e2e_fps",
        "value": round(fps, 2),
        "unit": "fps",
        "vs_baseline": round(mpxs / BASELINE_MPXS, 3),
        "decode_only_fps": round(dec_fps, 1),
        "workers": workers,
        "device": device_record(devices[:1]),
        "card": card_power_line(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
