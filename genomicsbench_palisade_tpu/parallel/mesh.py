"""Mesh construction and data-parallel batch sharding.

The genomics kernels are embarrassingly batch-parallel (the reference used
OpenMP dynamic scheduling over read batches, fmi.cpp:241-253 etc.); here
that becomes a 1-D (or hosts x devices 2-D) mesh with the batch dimension
sharded and results merged by collectives where needed (k-mer histograms:
psum; SMEM/alignment assembly: all_gather).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DP_AXIS = "dp"


def make_mesh(n_devices: int | None = None, axis: str = DP_AXIS) -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0, fill=0):
    n = arr.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, rem)
    return np.pad(arr, pad, constant_values=fill), n


def shard_batch(batch: dict, mesh: Mesh, axis: str = DP_AXIS):
    """Pad dim 0 of every array to the mesh size and shard it."""
    ndev = mesh.devices.size
    sharding = NamedSharding(mesh, P(axis))
    out = {}
    n_orig = None
    for key, arr in batch.items():
        arr = np.asarray(arr)
        padded, n = pad_to_multiple(arr, ndev, axis=0)
        n_orig = n if n_orig is None else n_orig
        out[key] = jax.device_put(padded, sharding)
    return out, n_orig


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None):
    """Multi-host bring-up (jax.distributed).  The reference is single-node
    (SURVEY.md §2.4: no MPI/NCCL); N-host scaling is a new capability.
    No-ops when already initialized or when env vars configure it."""
    import jax

    if jax.process_count() > 1:
        return  # already multi-process
    if coordinator is None:
        return  # single-process run
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def host_local_slice(n_items: int) -> slice:
    """This host's slice of a globally ordered input list: per-host input
    sharding over DCN (each host reads only its shard of the FASTQ/pairs)."""
    import jax

    per = -(-n_items // jax.process_count())
    lo = jax.process_index() * per
    return slice(lo, min(lo + per, n_items))


def shard_work_imbalance(work_per_item, n_shards: int) -> float:
    """Static-sharding analog of the reference's maxTicks/avgTicks load
    imbalance (fmi.cpp:362-370): item work (e.g. DP cells) is assigned
    round-robin to shards; returns max/avg shard work."""
    work = np.asarray(work_per_item, np.float64)
    shard_tot = np.zeros(n_shards)
    for i, w in enumerate(work):
        shard_tot[i % n_shards] += w
    avg = shard_tot.mean()
    return float(shard_tot.max() / avg) if avg > 0 else 1.0
