"""Exact GP regression (conjugate baseline — BASELINE config 1).

The reference gets this from GPflow (``gpflow.models.GPR``); it is the
closed-form oracle the SVGP tests converge to as M → N (SURVEY.md §4).
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp
from jax import scipy as jsp
from gpsig import struct

from gpsig.config import default_jitter, precise_linalg
from gpsig import gauss
from gpsig.likelihoods import Gaussian


@struct.dataclass
class GPR:
    kernel: Any
    likelihood: Gaussian

    @classmethod
    def create(cls, kernel, noise_variance=1.0, dtype=jnp.float64):
        return cls(kernel=kernel,
                   likelihood=Gaussian.create(noise_variance, dtype))

    @precise_linalg
    def log_marginal_likelihood(self, X, Y):
        """log N(Y | 0, K + σ²I), summed over output columns."""
        K = self.kernel.K(X)
        N = K.shape[0]
        Ky = K + (
            self.likelihood.variance + default_jitter(K.dtype)
        ) * jnp.eye(N, dtype=K.dtype)
        L = gauss.stable_cholesky(Ky)
        Y = Y.reshape(N, -1)
        alpha = jsp.linalg.solve_triangular(L, Y, lower=True)
        C = Y.shape[1]
        return (
            -0.5 * jnp.sum(alpha**2)
            - C * jnp.sum(jnp.log(jnp.diagonal(L)))
            - 0.5 * N * C * jnp.log(2.0 * jnp.pi)
        )

    @precise_linalg
    def predict_f(self, X, Y, Xnew, full_cov=False):
        K = self.kernel.K(X)
        N = K.shape[0]
        Ky = K + (
            self.likelihood.variance + default_jitter(K.dtype)
        ) * jnp.eye(N, dtype=K.dtype)
        L = gauss.stable_cholesky(Ky)
        Kmn = self.kernel.K(X, Xnew)  # [N, N*]
        A = jsp.linalg.solve_triangular(L, Kmn, lower=True)
        V = jsp.linalg.solve_triangular(L, Y.reshape(N, -1), lower=True)
        mean = A.T @ V
        if full_cov:
            var = self.kernel.K(Xnew) - A.T @ A
        else:
            var = self.kernel.Kdiag(Xnew) - jnp.sum(A**2, axis=0)
            var = var[:, None] * jnp.ones_like(mean)
        return mean, var

    def predict_y(self, X, Y, Xnew):
        m, v = self.predict_f(X, Y, Xnew)
        return self.likelihood.predict_mean_and_var(m, v)
