"""What a measurement runs on: the GPU check and the card's identity.

Every timed result names its device; a measurement that finds no GPU fails
instead of falling back to the CPU.
"""

from __future__ import annotations

import subprocess

import jax


class NoGpuError(RuntimeError):
    """JAX's default device is not a GPU."""


def require_gpu(devices=None) -> list:
    """The JAX devices, or NoGpuError when the default one is not a GPU."""
    devices = jax.devices() if devices is None else devices
    if not devices or devices[0].platform != "gpu":
        found = devices[0].platform if devices else "none"
        raise NoGpuError(f"JAX found no GPU (default device platform: {found})")
    return devices


def device_record(devices) -> dict:
    """The device as JAX reports it: platform, device_kind, count."""
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def card_power_line() -> str:
    """``name, power.limit`` of each card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()
