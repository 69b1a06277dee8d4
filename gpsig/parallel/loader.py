"""Sharded minibatch dataloader (BASELINE: "sharded minibatch dataloader").

The reference feeds minibatches by numpy indexing into a feed dict
(SURVEY.md §3.5 — no tf.data pipeline). Here: a host-side sampler that
device-puts each batch with the leading axis sharded over the mesh's
``data`` axis, with one-batch lookahead so host indexing/transfer overlaps
device compute (the classic prefetch-to-device pattern).
"""

from __future__ import annotations

import numpy as np

import jax

from gpsig.parallel.mesh import batch_sharding


class ShardedLoader:
    """Infinite uniform-without-replacement minibatch stream.

    Yields (X_batch, y_batch) device arrays sharded over ``data``. Batch
    size is rounded down to a multiple of the data-axis size."""

    def __init__(self, mesh, X, y, batch_size, seed=0, prefetch=True):
        self.mesh = mesh
        n_dev = mesh.devices.shape[0]
        self.batch = max(n_dev, batch_size - batch_size % n_dev)
        self.X = np.asarray(X)
        self.y = np.asarray(y)
        self.N = self.X.shape[0]
        self.rng = np.random.default_rng(seed)
        self.sharding = batch_sharding(mesh)
        self.prefetch = prefetch
        self._next = None

    def _sample(self):
        if self.batch >= self.N:
            idx = np.arange(self.N)
        else:
            idx = self.rng.choice(self.N, self.batch, replace=False)
        xb = jax.device_put(self.X[idx], self.sharding)
        yb = jax.device_put(self.y[idx], self.sharding)
        return xb, yb

    def __iter__(self):
        return self

    def __next__(self):
        if not self.prefetch:
            return self._sample()
        if self._next is None:
            self._next = self._sample()
        out = self._next
        self._next = self._sample()  # enqueue next while device computes
        return out
