"""Deterministic problem + step runner for multi-process harness checks.

The reference has no distributed runtime at all (SURVEY.md §2.4); the
rebuild's comm backend is ``jax.distributed`` + GSPMD collectives. This
module pins down one small, fully deterministic SVGP training problem that
both the real 2-process harness (``scripts/distributed_worker.py``,
exercised by ``tests/test_distributed.py``) and an in-process reference run
can execute, so the cross-host code path is checked for *numerical
equality* against single-process execution — not just "it didn't crash".

Everything here must be a pure function of the constants below: every
process builds the same global arrays and the same model.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
import optax

from gpsig import likelihoods as liks
from gpsig.inducing import make_inducing_tensors_from_data
from gpsig.kernels.signature import SignatureRBF
from gpsig.models.svgp import SVGP
from gpsig.parallel import mesh as meshlib
from gpsig.parallel.train import make_sharded_step_fn
from gpsig.training.loop import init_state

N, L, D, C, M, NL = 64, 12, 2, 2, 6, 2
SEED = 7


def build_problem(dtype=jnp.float64):
    rng = np.random.default_rng(SEED)
    X = jnp.asarray(
        (0.4 * rng.standard_normal((N, L, D))).cumsum(axis=1), dtype
    )
    Y = jnp.asarray(rng.integers(0, C, N))
    kern = SignatureRBF(D, NL, lengthscales=1.0, order=1, dtype=dtype)
    feat = make_inducing_tensors_from_data(
        jax.random.PRNGKey(1), X, num_tensors=M, num_levels=NL,
        num_features=D,
    )
    model = SVGP.create(kern, liks.MultiClass(num_classes=C), feat,
                        num_latent=C, dtype=dtype)
    return model, X, Y


def make_global_batch(mesh, X, Y):
    """Shard the (identical-on-every-process) global batch over ``data``.

    Uses make_array_from_callback so the same code works in single- and
    multi-process runs (device_put cannot target non-addressable shards).
    """
    sh = meshlib.batch_sharding(mesh)
    Xg = jax.make_array_from_callback(X.shape, sh, lambda idx: X[idx])
    sh_y = meshlib.batch_sharding(mesh)
    Yg = jax.make_array_from_callback(Y.shape, sh_y, lambda idx: Y[idx])
    return Xg, Yg


def run_steps(mesh, num_iters=5, dtype=jnp.float64):
    """Run ``num_iters`` sharded natgrad+Adam steps; returns
    (final elbo, checksum over all model leaves) as python floats —
    replicated outputs, identical on every process."""
    model, X, Y = build_problem(dtype)
    opt = optax.adam(1e-2)
    state = init_state(model, opt)
    step = make_sharded_step_fn(opt, num_data=N, mesh=mesh, gamma=0.1)
    Xg, Yg = make_global_batch(mesh, X, Y)
    elbo = None
    for i in range(num_iters):
        state, elbo = step(state, Xg, Yg, jax.random.PRNGKey(100 + i))
    leaves = jax.tree_util.tree_leaves(state.model)
    checksum = sum(
        float(jnp.sum(jnp.abs(l.astype(jnp.float64)))) for l in leaves
        if hasattr(l, "dtype") and jnp.issubdtype(l.dtype, jnp.floating)
    )
    return float(elbo), checksum
