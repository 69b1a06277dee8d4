"""Sharded SVI: data-parallel ELBO, natural-gradient and Adam steps.

This is the data-parallel layer the reference never had
(SURVEY.md §2.4): the minibatch is sharded over the mesh's ``data`` axis
with `shard_map`; each device computes its shard's variational expectations
and parameter gradients locally, and the cross-device reduction is a single
``psum`` over the interconnect. The model (kernel hypers, inducing variables, q) is
replicated — exactly the regime of the reference's M≈500 benchmarks.

Design notes
------------
- The per-shard loss is  scale·Σ_local var_exp − KL/n_shards  so that
  psum(local_elbo) = ELBO and psum(local_grads) = ∇ELBO. The KL and its
  gradient are computed redundantly on every device (cheap, O(M³) once) —
  redundant replicated compute beats a second collective.
- Natural-gradient statistics (∂L/∂μ, ∂L/∂S) are psum-reduced the same way,
  then the (replicated, deterministic) natgrad update runs identically on
  all devices: no parameter broadcast needed.
- With GSPMD this whole function could be a plain ``jit`` with shardings;
  `shard_map` is used so the collective structure is explicit and stable.
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
import optax
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from gpsig.parallel.mesh import DATA_AXIS, TILE_AXIS
from gpsig.training.loop import TrainState


def _local_elbo(model, X, Y, num_data, key, n_shards):
    """Per-shard ELBO contribution (psum-able)."""
    if hasattr(model.inducing, "covariances"):
        Kuu, Kuf = model.inducing.covariances(model.kernel, X)
    else:
        Kuu = model.inducing.Kuu(model.kernel)
        Kuf = model.inducing.Kuf(model.kernel, X)
    Knn = model.kernel.Kdiag(X)
    from gpsig import gauss

    L = gauss.stable_cholesky(Kuu)

    fmean, fvar = gauss.conditional(
        Kuf, Kuu, Knn, model.q_mu, model._tril_q_sqrt(),
        white=model.whiten, Kmm_chol=L,
    )
    var_exp = model.likelihood.variational_expectations(Y, fmean, fvar,
                                                        key=key)
    batch_global = fmean.shape[0] * n_shards
    scale = jnp.asarray(num_data, fmean.dtype) / batch_global
    if model.whiten:
        kl = gauss.gauss_kl(model.q_mu, model._tril_q_sqrt())
    else:
        kl = gauss.gauss_kl(model.q_mu, model._tril_q_sqrt(), K_chol=L)
    return scale * jnp.sum(var_exp) - kl / n_shards


def make_sharded_step_fn(
    optimizer: optax.GradientTransformation,
    num_data: int,
    mesh,
    gamma: float = 0.1,
    use_natgrad: bool = True,
):
    """Jitted data-parallel training step over ``mesh``.

    Returns step(state, X, Y, key) -> (state, elbo); X/Y must be sharded
    with leading axis over the ``data`` axis (see mesh.shard_batch)."""
    n_shards = mesh.shape[DATA_AXIS]
    rep = P()
    dat = P(DATA_AXIS)

    def _step_local(state: TrainState, X, Y, key):
        model = state.model

        if use_natgrad:
            mu = model.q_mu
            if model.q_diag:
                S = model.q_sqrt**2
            else:
                Lq = jnp.tril(model.q_sqrt)
                S = jnp.einsum("cij,ckj->cik", Lq, Lq)

            def nat_loss(mu_, S_):
                if model.q_diag:
                    m_ = model.replace(q_mu=mu_, q_sqrt=jnp.sqrt(S_))
                else:
                    m_ = model.replace(
                        q_mu=mu_, q_sqrt=jnp.linalg.cholesky(S_)
                    )
                return _local_elbo(m_, X, Y, num_data, key, n_shards)

            g_mu, g_S = jax.grad(nat_loss, argnums=(0, 1))(mu, S)
            g_mu = jax.lax.psum(g_mu, DATA_AXIS)
            g_S = jax.lax.psum(g_S, DATA_AXIS)
            model = _apply_natgrad(model, mu, S, g_mu, g_S, gamma)

        def loss_fn(m):
            return -_local_elbo(m, X, Y, num_data, key, n_shards)

        loss, grads = jax.value_and_grad(loss_fn)(model)
        loss = jax.lax.psum(loss, DATA_AXIS)
        grads = jax.lax.psum(grads, DATA_AXIS)
        if use_natgrad:
            grads = grads.replace(
                q_mu=jnp.zeros_like(grads.q_mu),
                q_sqrt=jnp.zeros_like(grads.q_sqrt),
            )
        updates, opt_state = optimizer.update(grads, state.opt_state, model)
        model = optax.apply_updates(model, updates)
        return TrainState(model, opt_state, state.step + 1), -loss

    sharded = shard_map(
        _step_local,
        mesh=mesh,
        in_specs=(rep, dat, dat, rep),
        out_specs=(rep, rep),
        check_vma=False,
    )
    return jax.jit(sharded)


def _apply_natgrad(model, mu, S, g_mu, g_S, gamma, jitter=1e-8):
    """Replicated natgrad update from (already psum-reduced) gradients."""
    from gpsig.training.natgrad import gaussian_natgrad_update

    mu_new, q_sqrt_new = gaussian_natgrad_update(
        mu, S, g_mu, g_S, gamma, jitter, model.q_diag
    )
    return model.replace(q_mu=mu_new, q_sqrt=q_sqrt_new)


def sharded_gram(kernel, mesh, X, X2=None, block=None):
    """Signature Gram matrix tiled over the full (data × tile) mesh.

    Rows shard over ``data``, columns over ``tile``; every device computes
    its [N1/p, N2/q] block with the local DP recursion — zero communication
    (SURVEY.md §2.4 'tensor parallel' row: Gram-tile parallelism)."""
    X = jnp.asarray(X)
    X2v = X if X2 is None else jnp.asarray(X2)

    def local(Xr, Xc):
        return kernel.K(Xr, Xc)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(DATA_AXIS), P(TILE_AXIS)),
        out_specs=P(DATA_AXIS, TILE_AXIS),
        check_vma=False,
    )
    return jax.jit(fn)(X, X2v)
