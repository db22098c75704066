"""Gate the device SSIMULACRA2 score against an externally published value.

The reference project pins its GPU implementation to the C reference's
17.398505 on a sample image pair (ssimulacra2-cuda/examples/compare.rs:70-95)
with a +-0.25 budget.  This tool applies the same external-anchor gate to the
device pipeline with the tighter +-0.05 budget from BASELINE.md — run it with
any input pair whose score was produced by an independent implementation
(cloudinary's ssimulacra2 CLI, libjxl's ssimulacra2, or the reference):

    python tools/ssimulacra2_anchor.py ref.png dis.png 17.398505

Exits 0 iff |device_score - expected| <= budget (default 0.05).  The build
environment for this repo ships no such assets (docs/VALIDATION.md), so this
gate cannot run in CI here; it is the documented procedure for closing the
external-anchor gap wherever assets exist.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    if len(sys.argv) < 4:
        print(__doc__)
        return 2
    ref_path, dis_path, expected = sys.argv[1], sys.argv[2], float(sys.argv[3])
    budget = float(sys.argv[4]) if len(sys.argv) > 4 else 0.05

    import numpy as np

    from turbo_metrics_tpu.io.probe import create_source
    from turbo_metrics_tpu.models.ssimulacra2 import Ssimulacra2
    from turbo_metrics_tpu.ops.colorspace import srgb_to_linear
    from turbo_metrics_tpu.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()

    frames = []
    for p in (ref_path, dis_path):
        f = create_source(p).get_frame()
        if f is None or f.rgb is None:
            print(f"could not read an RGB frame from {p}")
            return 2
        frames.append(np.asarray(srgb_to_linear(f.rgb, depth=f.depth)))
    h, w = frames[0].shape[:2]
    s2 = Ssimulacra2(w, h)
    score = s2.score_pair(frames[0], frames[1])
    delta = abs(score - expected)
    ok = delta <= budget
    print(
        f"device={score:.6f} expected={expected:.6f} delta={delta:.6f} "
        f"budget={budget} -> {'OK' if ok else 'FAIL'}"
    )
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
