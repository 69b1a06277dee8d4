"""Device-mesh construction and axis conventions.

The reference has **no** distributed layer at all (SURVEY.md §1: single
process, TF1 intra-op threading, single-GPU CUDA solver). This module is the
named "multi-host collective layer" of this build (§2.4): one
place that fixes the mesh axes every sharded component agrees on:

- ``data``: minibatch / chain parallelism. ELBO terms, natural-gradient
  statistics and NUTS adaptation statistics are ``psum``-reduced over it
  (NVLink within a host, the network across hosts via jax.distributed).
  Every card of a host reaches every other at the same rate, so the mesh
  shape follows the algorithm alone.
- ``tile``: Gram-block parallelism. The [N1, N2] signature Gram and
  [M, B] cross-covariance tile over it; per-pair DP recursions are
  independent, so the axis is communication-free.

``jax.sharding.Mesh`` + GSPMD collectives (which XLA hands to NCCL) *are*
the backend: there is nothing else to build, only these conventions.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
TILE_AXIS = "tile"


def make_mesh(data=None, tile=1, devices=None):
    """Build a (data, tile) mesh. Defaults: all devices on ``data``."""
    devices = jax.devices() if devices is None else devices
    n = len(devices)
    if data is None:
        data = n // tile
    if data * tile != n:
        raise ValueError(f"data*tile = {data*tile} != {n} devices")
    arr = np.asarray(devices).reshape(data, tile)
    return Mesh(arr, (DATA_AXIS, TILE_AXIS))


def init_distributed(coordinator=None, num_processes=None, process_id=None):
    """Multi-host entry point (jax.distributed); no-op when single-host."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def batch_sharding(mesh):
    """Sharding for [N, ...] data batches: split N over the data axis."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh):
    return NamedSharding(mesh, P())


def shard_batch(mesh, *arrays):
    """Device-put arrays with the leading axis sharded over ``data``."""
    sh = batch_sharding(mesh)
    out = tuple(jax.device_put(a, sh) for a in arrays)
    return out if len(out) > 1 else out[0]
