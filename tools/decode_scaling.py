"""Decode scale-out overhead measurement (VERDICT r3 item 7).

The dev host has ONE core, so near-linear *speedup* from
parallel/decode_pool.py cannot be demonstrated here; what CAN be bounded
is the pool's per-worker *overhead*: N seek-partitioned workers decoding
disjoint chunks of the same clip do strictly more work than one
sequential decoder (each chunk seeks to the preceding keyframe and
decode-discards up to its first frame), and on one core any
coordination/GIL cost shows up directly as wall-time above the N=1 run.
overhead(N) = wall(N) / wall(1) - 1 on a single core is an upper bound
on the per-worker efficiency loss on a real multi-core host (there the
discard work runs concurrently instead of serially).

Usage: python tools/decode_scaling.py [N ...]   (default 1 2 4 8)
       python tools/decode_scaling.py --chunks [C ...]  (chunk-size sweep
           at workers=4: bounds overhead(chunk), closing the round-4
           "shrinks proportionally at production chunk sizes" claim)
       python tools/decode_scaling.py --sd  (decode-only fps at the
           reference's own 720x576 config, sequential)
Decodes the cached bench_e2e reference clip with ChunkedVideoSource and
prints wall-time, fps and overhead vs N=1.  Pure host work, no device.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _drain(src):
    count = 0
    csum = 0
    while True:
        f = src.next_frame()
        if f is None:
            break
        count += 1
        csum ^= int(f.y[0, 0])
    return count, csum


def main() -> int:
    from bench_e2e import CACHE, NFRAMES, make_clip
    from turbo_metrics_tpu.parallel.decode_pool import ChunkedVideoSource

    H, W = 1080, 1920
    path = os.path.join(CACHE, f"e2e_ref_{W}x{H}_{NFRAMES}.ts")
    if not os.path.exists(path):
        t0 = time.perf_counter()
        make_clip(path, seed=1)
        print(f"encoded clip in {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    if "--sd" in sys.argv[1:]:
        # Decode-only rate at the reference's own 720x576 config
        # (turbo-metrics-cli README: H.262 ref, 277 Mpx/s headline).
        from turbo_metrics_tpu.io.probe import create_source

        sd = os.path.join(CACHE, f"e2e_ref_720x576_{NFRAMES}.ts")
        if not os.path.exists(sd):
            make_clip(sd, seed=1, w=720, h=576)
        for rep in range(3):
            src = create_source(sd)
            t0 = time.perf_counter()
            count, _ = _drain(src)
            dt = time.perf_counter() - t0
            src.close()
            print(f"720x576 MPEG-2 sequential decode: {count / dt:7.1f} fps "
                  f"({count} frames in {dt:.2f}s)")
        return 0

    if "--chunks" in sys.argv[1:]:
        args = sys.argv[sys.argv.index("--chunks") + 1:]
        chunks = [int(a) for a in args] or [16, 32, 64, 96]
        src = ChunkedVideoSource(path, workers=1, chunk=NFRAMES)
        t0 = time.perf_counter()
        count, base_csum = _drain(src)
        base = time.perf_counter() - t0
        src.close()
        print(f"workers=1 chunk={NFRAMES} (sequential): {base:6.2f}s "
              f"{count / base:6.1f} fps")
        for c in chunks:
            src = ChunkedVideoSource(path, workers=4, chunk=c)
            t0 = time.perf_counter()
            count, csum = _drain(src)
            dt = time.perf_counter() - t0
            src.close()
            assert count == NFRAMES and csum == base_csum, (count, csum)
            print(f"workers=4 chunk={c:3d}: {dt:6.2f}s  {count / dt:6.1f} fps  "
                  f"total-work overhead {dt / base - 1:+7.1%}")
        return 0

    ns = [int(a) for a in sys.argv[1:]] or [1, 2, 4, 8]
    base = None
    print(f"clip: {path} ({NFRAMES} frames {W}x{H} MPEG-2 TS); "
          f"host cores: {os.cpu_count()}")
    for n in ns:
        src = ChunkedVideoSource(path, workers=n, chunk=16)
        t0 = time.perf_counter()
        count = 0
        csum = 0
        while True:
            f = src.next_frame()
            if f is None:
                break
            count += 1
            csum ^= int(f.y[0, 0])  # consume (and checksum) every frame
        dt = time.perf_counter() - t0
        src.close()
        assert count == NFRAMES, (count, NFRAMES)
        if base is None:
            base = dt
        print(
            f"workers={n}: {dt:6.2f}s  {count / dt:6.1f} fps  "
            f"overhead vs N=1: {dt / base - 1.0:+6.1%}  (checksum {csum})"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
