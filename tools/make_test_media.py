"""Generate synthetic test media for the BASELINE.json configs.

Creates deterministic clip pairs (reference + distorted) without any
external assets:

  config 1: PNG still pair
  config 2: 720p Y4M pair (raw, no bitstream decode)
  config 3: 1080p compressed pair (VP9/MKV via OpenCV; H.264 if an encoder
            is available — decode side handles both through libav)
  config 4: 4K 10-bit Y4M pair (use --color-matrix bt2020 --color-transfer pq)
  config 5: reuses config 3 with multiple metrics

Usage: python tools/make_test_media.py OUTDIR [--small]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from turbo_metrics_tpu.io.y4m import write_y4m  # noqa: E402


def synth_luma(w, h, t, rng):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return (
        120
        + 60 * np.sin(xx / 23.0 + t * 0.31) * np.cos(yy / 17.0)
        + 40 * np.sin((xx + yy) / 41.0 + t * 0.17)
    )


def make_pair_y4m(outdir, name, w, h, n, depth, noise, rng):
    hi = (1 << depth) - 1
    scale = hi / 255.0
    refs, diss = [], []
    for t in range(n):
        y = np.clip(synth_luma(w, h, t, rng) * scale, 0, hi)
        u = np.full(((h + 1) // 2, (w + 1) // 2), (hi + 1) // 2 - 8 * scale)
        v = np.full(((h + 1) // 2, (w + 1) // 2), (hi + 1) // 2 + 6 * scale)
        yd = np.clip(y + rng.normal(0, noise * scale, y.shape), 0, hi)
        refs.append((y, u, v))
        diss.append((yd, u, v))
    write_y4m(outdir / f"{name}_ref.y4m", refs, w, h, depth=depth)
    write_y4m(outdir / f"{name}_dis.y4m", diss, w, h, depth=depth)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir", type=Path)
    ap.add_argument("--small", action="store_true", help="tiny dims for quick tests")
    ap.add_argument("--frames", type=int, default=32)
    args = ap.parse_args()
    args.outdir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(42)
    sc = 8 if args.small else 1

    # config 1: PNG pair
    from PIL import Image

    w, h = 1280 // sc, 720 // sc
    img = np.stack(
        [np.clip(synth_luma(w, h, t, rng), 0, 255).astype(np.uint8) for t in range(3)],
        axis=-1,
    )
    dis = np.clip(
        img.astype(np.int16) + rng.integers(-8, 9, img.shape), 0, 255
    ).astype(np.uint8)
    Image.fromarray(img).save(args.outdir / "still_ref.png")
    Image.fromarray(dis).save(args.outdir / "still_dis.png")

    # config 2: 720p Y4M
    make_pair_y4m(args.outdir, "c2_720p", 1280 // sc, 720 // sc, args.frames, 8, 5, rng)

    # config 3/5: compressed 1080p (VP9/MKV through OpenCV's encoder)
    try:
        import cv2

        w, h = 1920 // sc, 1080 // sc
        for name, noise in (("c3_ref", 0), ("c3_dis", 6)):
            vw = cv2.VideoWriter(
                str(args.outdir / f"{name}.mkv"),
                cv2.VideoWriter_fourcc(*"VP90"),
                25,
                (w, h),
            )
            for t in range(args.frames):
                y = np.clip(synth_luma(w, h, t, rng), 0, 255)
                if noise:
                    y = np.clip(y + rng.normal(0, noise, y.shape), 0, 255)
                frame = np.repeat(y[..., None].astype(np.uint8), 3, axis=-1)
                vw.write(frame)
            vw.release()
    except Exception as e:  # pragma: no cover
        print(f"skipping compressed clips: {e}", file=sys.stderr)

    # config 4: 4K 10-bit Y4M (drive with --color-matrix bt2020 --color-transfer pq)
    make_pair_y4m(
        args.outdir, "c4_4k10", 3840 // sc, 2160 // sc, max(4, args.frames // 4), 10, 12, rng
    )
    print(f"wrote test media to {args.outdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
