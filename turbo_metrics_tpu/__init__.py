"""turbo-metrics-tpu: full-reference video/image quality metrics in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of Gui-Yom/turbo-metrics:
host-side demuxing/decoding feeds planar YUV/RGB frames into batched XLA
programs computing PSNR, SSIM, MS-SSIM, SSIMULACRA2, XPSNR and VMAF
elementary features on the accelerator (an NVIDIA GPU; the CPU for tests).
"""

__version__ = "0.1.0"

from turbo_metrics_tpu.engine import (  # noqa: F401
    FrameScores,
    Metrics,
    MetricsResults,
    Options,
    TurboMetrics,
)
