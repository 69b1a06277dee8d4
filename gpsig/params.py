"""Parameter transforms (bijectors) for constrained optimisation.

Re-implements, JAX-natively, the role of GPflow 1.x's ``gpflow.transforms``
(reference behavior: ``gpflow.params.Parameter`` stores an unconstrained value
and maps it through a bijective transform; ``positive`` is softplus,
lag/weight parameters use a ``Logistic`` transform — see SURVEY.md §2.3).

Design: models in this library are `gpsig.struct` dataclasses whose pytree
leaves are *unconstrained* arrays. Constrained values are exposed through
properties that apply the forward transforms below. Optimisers (optax / the
natural-gradient optimiser) act on the unconstrained leaves, exactly as
GPflow's optimisers act on the free-state vector.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import nn


def softplus(x):
    return nn.softplus(x)


def inv_softplus(y):
    """Inverse of softplus, numerically stable for large and small y."""
    y = jnp.asarray(y)
    # log(expm1(y)) = y + log1p(-exp(-y)); stable for y not tiny.
    # For tiny y, log(expm1(y)) ~= log(y).
    safe = jnp.maximum(y, 1e-10)
    return jnp.where(
        safe > 20.0, safe, jnp.log(jnp.expm1(safe))
    )


def positive(x):
    """Unconstrained -> positive (softplus, as in gpflow's default)."""
    return softplus(x)


def inv_positive(y):
    return inv_softplus(y)


def sigmoid(x):
    return nn.sigmoid(x)


def logistic(x, lo=0.0, hi=1.0):
    """Unconstrained -> (lo, hi) via a scaled sigmoid (gpflow ``Logistic``)."""
    return lo + (hi - lo) * nn.sigmoid(x)


def inv_logistic(y, lo=0.0, hi=1.0):
    t = (jnp.asarray(y) - lo) / (hi - lo)
    t = jnp.clip(t, 1e-12, 1.0 - 1e-12)
    return jnp.log(t) - jnp.log1p(-t)


def vec_to_tril(v, n):
    """Pack a vector of length n(n+1)/2 into a lower-triangular [n, n] matrix.

    Row-major over the lower triangle (matches the layout used by our
    ``tril_to_vec``; any fixed convention works since we control both sides).
    """
    idx = jnp.tril_indices(n)
    return jnp.zeros((n, n), v.dtype).at[idx].set(v)


def tril_to_vec(m):
    n = m.shape[-1]
    idx = jnp.tril_indices(n)
    return m[..., idx[0], idx[1]]
