"""Likelihoods with variational expectations (GPflow-1.x parity surface).

Re-implements the dependency-owned likelihood layer the reference uses
(SURVEY.md §2.3: ``gpflow.likelihoods.{Gaussian, Bernoulli, MultiClass,
SoftMax}``; the reference's own ``gpsig/likelihoods.py`` adds a Monte-Carlo
softmax). Gaussian is closed-form; Bernoulli and MultiClass(RobustMax) use
Gauss–Hermite quadrature; Softmax uses reparameterised Monte Carlo.

All `variational_expectations` take marginal means/variances [N, C] and
return per-datapoint expectations [N]. Quadrature weights are baked as
static constants (no data-dependent shapes under jit).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from gpsig import struct

from gpsig import params as pr

_GH_POINTS = 30


def _gh(n=_GH_POINTS):
    x, w = np.polynomial.hermite.hermgauss(n)
    return x, w


def _normal_cdf(x):
    return 0.5 * (1.0 + jax.scipy.special.erf(x / np.sqrt(2.0)))


@struct.dataclass
class Gaussian:
    """y = f + ε, ε ~ N(0, σ²)."""

    raw_variance: jnp.ndarray

    @classmethod
    def create(cls, variance=1.0, dtype=jnp.float64):
        return cls(raw_variance=pr.inv_positive(jnp.asarray(variance, dtype)))

    @property
    def variance(self):
        return pr.positive(self.raw_variance)

    needs_key = False

    def variational_expectations(self, Y, Fmu, Fvar, key=None):
        s2 = self.variance
        out = (
            -0.5 * jnp.log(2.0 * jnp.pi * s2)
            - 0.5 * ((Y - Fmu) ** 2 + Fvar) / s2
        )
        return jnp.sum(out, axis=-1)

    def predict_mean_and_var(self, Fmu, Fvar):
        return Fmu, Fvar + self.variance

    def predict_log_density(self, Y, Fmu, Fvar):
        s2 = self.variance + Fvar
        out = -0.5 * jnp.log(2.0 * jnp.pi * s2) - 0.5 * (Y - Fmu) ** 2 / s2
        return jnp.sum(out, axis=-1)


@struct.dataclass
class Bernoulli:
    """p(y=1|f) = Φ(f) (probit link), y ∈ {0, 1}."""

    needs_key = False

    def variational_expectations(self, Y, Fmu, Fvar, key=None):
        x, w = _gh()
        x = jnp.asarray(x, Fmu.dtype)
        w = jnp.asarray(w, Fmu.dtype)
        f = Fmu[..., None] + jnp.sqrt(2.0 * Fvar[..., None]) * x
        sign = 2.0 * Y[..., None] - 1.0
        logp = jnp.log(jnp.clip(_normal_cdf(sign * f), 1e-12, 1.0))
        out = jnp.sum(logp * w, axis=-1) / np.sqrt(np.pi)
        return jnp.sum(out, axis=-1)

    def predict_mean_and_var(self, Fmu, Fvar):
        p = _normal_cdf(Fmu / jnp.sqrt(1.0 + Fvar))
        return p, p - p**2

    def predict_log_density(self, Y, Fmu, Fvar):
        p = _normal_cdf(Fmu / jnp.sqrt(1.0 + Fvar))
        out = jnp.where(Y > 0.5, jnp.log(p + 1e-12), jnp.log(1 - p + 1e-12))
        return jnp.sum(out, axis=-1)


@struct.dataclass
class Softmax:
    """p(y=c|f) = softmax(f)_c with Monte-Carlo variational expectations
    (the reference's gpsig/likelihoods.py MC softmax — SURVEY.md §2.1)."""

    num_classes: int = struct.field(pytree_node=False)
    num_samples: int = struct.field(pytree_node=False, default=20)

    needs_key = True

    def variational_expectations(self, Y, Fmu, Fvar, key=None):
        # Y: [N] int class labels (or [N, 1]); Fmu/Fvar: [N, C]
        y = Y.reshape(-1).astype(jnp.int32)
        eps = jax.random.normal(
            key, (self.num_samples,) + Fmu.shape, Fmu.dtype
        )
        f = Fmu[None] + jnp.sqrt(jnp.maximum(Fvar, 1e-30))[None] * eps
        logp = jax.nn.log_softmax(f, axis=-1)  # [S, N, C]
        picked = jnp.take_along_axis(
            logp, y[None, :, None], axis=-1
        )[..., 0]
        return jnp.mean(picked, axis=0)  # [N]

    def predict_mean_and_var(self, Fmu, Fvar, key=None, num_samples=100):
        if key is None:
            key = jax.random.PRNGKey(0)
        eps = jax.random.normal(key, (num_samples,) + Fmu.shape, Fmu.dtype)
        f = Fmu[None] + jnp.sqrt(jnp.maximum(Fvar, 1e-30))[None] * eps
        p = jax.nn.softmax(f, axis=-1)
        pm = jnp.mean(p, axis=0)
        return pm, jnp.mean(p**2, axis=0) - pm**2

    def predict_log_density(self, Y, Fmu, Fvar, key=None, num_samples=100):
        p, _ = self.predict_mean_and_var(Fmu, Fvar, key, num_samples)
        y = Y.reshape(-1).astype(jnp.int32)
        return jnp.log(jnp.take_along_axis(p, y[:, None], axis=-1)[:, 0] + 1e-12)


@struct.dataclass
class MultiClass:
    """RobustMax multiclass (GPflow 1.x ``MultiClass`` default).

    p(y=c | f) = 1-ε if c = argmax f else ε/(C-1). The variational
    expectation needs P(f_y = max f), computed by 1-D Gauss–Hermite
    quadrature over f_y (GPflow's ``RobustMax.prob_is_largest``).
    """

    num_classes: int = struct.field(pytree_node=False)
    epsilon: float = struct.field(pytree_node=False, default=1e-3)

    needs_key = False

    def _prob_is_largest(self, Y, Fmu, Fvar):
        x, w = _gh()
        x = jnp.asarray(x, Fmu.dtype)
        w = jnp.asarray(w, Fmu.dtype)
        y = Y.reshape(-1).astype(jnp.int32)
        mu_y = jnp.take_along_axis(Fmu, y[:, None], axis=-1)  # [N, 1]
        var_y = jnp.take_along_axis(Fvar, y[:, None], axis=-1)
        f = mu_y + jnp.sqrt(2.0 * var_y) * x[None, :]  # [N, Q]
        # Π_{j≠y} Φ((f - μ_j)/σ_j)
        z = (f[:, None, :] - Fmu[:, :, None]) / jnp.sqrt(
            jnp.maximum(Fvar, 1e-30)
        )[:, :, None]  # [N, C, Q]
        cdfs = _normal_cdf(z)
        mask = jax.nn.one_hot(y, self.num_classes, dtype=Fmu.dtype)
        cdfs = cdfs * (1 - mask[:, :, None]) + mask[:, :, None]
        prod = jnp.prod(cdfs, axis=1)  # [N, Q]
        return jnp.sum(prod * w[None, :], axis=-1) / np.sqrt(np.pi)

    def variational_expectations(self, Y, Fmu, Fvar, key=None):
        p = self._prob_is_largest(Y, Fmu, Fvar)
        C = self.num_classes
        return p * np.log(1.0 - self.epsilon) + (1.0 - p) * np.log(
            self.epsilon / (C - 1)
        )

    def predict_mean_and_var(self, Fmu, Fvar):
        C = self.num_classes
        ps = []
        for c in range(C):
            yc = jnp.full((Fmu.shape[0],), c)
            ps.append(self._prob_is_largest(yc, Fmu, Fvar))
        p = jnp.stack(ps, axis=-1)
        p = p / jnp.sum(p, axis=-1, keepdims=True)
        p = p * (1.0 - self.epsilon) + (1.0 - p) * self.epsilon / (C - 1)
        return p, p - p**2

    def predict_log_density(self, Y, Fmu, Fvar):
        p, _ = self.predict_mean_and_var(Fmu, Fvar)
        y = Y.reshape(-1).astype(jnp.int32)
        return jnp.log(jnp.take_along_axis(p, y[:, None], axis=-1)[:, 0] + 1e-12)
