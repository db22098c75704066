"""Throughput of the metric engine at 1080p on one GPU, in frame pairs/s.

Times ``TurboMetrics.compute_frames`` — the engine's normal per-batch path:
host stacking, upload, the compiled step, the fetch and host scoring — on
seeded synthetic 8-bit 4:2:0 BT.709 frames held in host memory, after one
warm-up batch that compiles.  ROADMAP.md A1 owns the full benchmark (cells,
spans, trace reduction); this is the quick rate check.

    python bench.py [-m METRIC ...] [--batch N] [--iters K]

One process per card.  Prints one JSON line naming the device (platform,
device_kind, count) and the card's power limit; fails when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np

# The reference's headline: 669 fps / 277.47 Mpx/s, decode + compute, at
# 720x576 on an RTX 4070 (BASELINE.md).
BASELINE_MPXS = 277.47
METRICS = ("psnr", "ssim", "msssim", "ssimulacra2", "xpsnr", "vmaf")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-m", "--metrics", action="append", choices=METRICS)
    ap.add_argument("--batch", type=int, default=0,
                    help="frame pairs per step (0 = engine.default_batch)")
    ap.add_argument("--iters", type=int, default=8)
    args = ap.parse_args(argv)
    names = args.metrics or ["ssimulacra2"]

    from turbo_metrics_tpu.color.characteristics import height_fallback
    from turbo_metrics_tpu.engine import Metrics, TurboMetrics, default_batch
    from turbo_metrics_tpu.io.frame_source import RawFrame
    from turbo_metrics_tpu.parity import synthetic_clip
    from turbo_metrics_tpu.utils.compile_cache import enable_compilation_cache
    from turbo_metrics_tpu.utils.device import (
        card_power_line,
        device_record,
        require_gpu,
    )

    devices = require_gpu()
    enable_compilation_cache()
    w, h = 1920, 1080
    metrics = Metrics(**{m: True for m in names})
    batch = args.batch or default_batch(w, h)

    refs, diss = synthetic_clip(0, 2, h, w)

    def frames(clip):
        return [
            RawFrame(y=clip[i % 2][0], uv=np.stack(clip[i % 2][1:], -1), depth=8)
            for i in range(batch)
        ]

    f_ref, f_dis = frames(refs), frames(diss)
    cc = (height_fallback(h), "limited")
    eng = TurboMetrics(w, h, metrics, batch=batch)

    t0 = time.perf_counter()
    eng.compute_frames(f_ref, cc, f_dis, cc)
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        eng.compute_frames(f_ref, cc, f_dis, cc)
        times.append(time.perf_counter() - t0)
    rate = batch / statistics.median(times)
    mpxs = rate * w * h / 1e6
    print(json.dumps({
        "metric": f"{'+'.join(names)}_{w}x{h}_pairs_per_s",
        "value": rate,
        "unit": "pairs/s",
        "vs_baseline": mpxs / BASELINE_MPXS,
        "batch": batch,
        "iters": args.iters,
        "first_batch_s": compile_s,
        "device": device_record(devices[:1]),
        "card": card_power_line(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
