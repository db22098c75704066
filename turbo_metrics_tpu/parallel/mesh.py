"""Multi-device scaling via jax.sharding: data-parallel frame batches.

The workload is embarrassingly parallel over frame pairs (SURVEY.md section 5:
the reference has no cross-device sharding; its concurrency unit is the
frame).  The scale-out is therefore a 1-D device mesh with the batch axis
sharded across devices: XLA compiles one SPMD program, frames move only in
the initial host->device scatter, and per-frame scalar scores gather back
with no collectives in the hot path (VMAF motion's one shard-boundary frame
is a single ppermute).

TP/PP/EP have no analog here (no weights, no layers, no experts); the SP
analog (sharding a single frame's rows across devices with halo exchange for
the blurs) is provided by ``spatial_shard_blur`` as a building block.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

FRAME_AXIS = "frames"


def make_mesh(n_devices: Optional[int] = None, *, axis: str = FRAME_AXIS) -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"requested {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


def frame_sharding(mesh: Mesh, ndim: int, *, axis: str = FRAME_AXIS) -> NamedSharding:
    """Shard the leading (batch) dim across the mesh; replicate the rest."""
    return NamedSharding(mesh, P(axis, *([None] * (ndim - 1))))


def shard_over_frames(
    fn: Callable,
    mesh: Mesh,
    *,
    in_ndims: Sequence[int],
    axis: str = FRAME_AXIS,
):
    """jit ``fn`` with every input's leading dim sharded over the mesh.

    Outputs inherit shardings from XLA's propagation; per-frame outputs stay
    frame-sharded, scalars replicate.
    """
    in_shardings = tuple(frame_sharding(mesh, nd, axis=axis) for nd in in_ndims)
    return jax.jit(fn, in_shardings=in_shardings)


def spatial_sharding(mesh: Mesh, ndim: int, *, axis: str = FRAME_AXIS) -> NamedSharding:
    """Shard the width (last) axis across the mesh — the SP analog.

    For a single huge frame (8K stills) the batch axis may be 1; sharding W
    instead splits one frame's columns across devices.  The separable blurs'
    shifted slices make XLA's SPMD partitioner insert halo exchanges
    (collective-permute over ICI) automatically — no manual ring code.
    """
    spec = [None] * ndim
    spec[-1] = axis
    return NamedSharding(mesh, P(*spec))


def shard_over_width(fn, mesh: Mesh, *, in_ndims: Sequence[int], axis: str = FRAME_AXIS):
    """jit ``fn`` with every input's width axis sharded over the mesh."""
    in_shardings = tuple(spatial_sharding(mesh, nd, axis=axis) for nd in in_ndims)
    return jax.jit(fn, in_shardings=in_shardings)


def pad_batch_to_mesh(arr: np.ndarray, mesh: Mesh) -> tuple[np.ndarray, int]:
    """Pad the batch dim to a multiple of the mesh size (repeat last frame).

    Returns (padded, original_length).
    """
    n = arr.shape[0]
    size = int(np.prod(mesh.devices.shape))
    pad = (-n) % size
    if pad:
        arr = np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)], axis=0)
    return arr, n
