"""Sparse variational GP (SVGP) with whitened parameterisation.

Re-implements the dependency-owned model layer the reference builds on
(SURVEY.md §2.3 / §3.1: ``gpflow.models.SVGP._build_likelihood`` — the ELBO
with minibatch scaling — and ``_build_predict``), as a pure-functional JAX
model whose pytree leaves are the variational and hyper parameters.

ELBO = (N/B) Σ_batch E_q[log p(y_i | f_i)] − KL[q(u) ‖ p(u)].

whiten=True (the reference's benchmark setting): u = L v, q(v) = N(μ, SSᵀ),
KL is against N(0, I) and the conditional projects through L⁻¹Kuf.

The entire step — Gram construction, DP recursions, chol +
triangular solves, likelihood quadrature — is one jitted function;
``gpsig/parallel`` shards it over a device mesh.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
from gpsig import struct
from jax import scipy as jsp

from gpsig import gauss
from gpsig.config import precise_linalg


@struct.dataclass
class SVGP:
    kernel: Any
    likelihood: Any
    inducing: Any
    q_mu: jnp.ndarray  # [M, C]
    q_sqrt: jnp.ndarray  # [C, M, M] (lower-tri used) or [M, C] if q_diag
    whiten: bool = struct.field(pytree_node=False, default=True)
    q_diag: bool = struct.field(pytree_node=False, default=False)

    @classmethod
    def create(cls, kernel, likelihood, inducing, num_latent,
               whiten=True, q_diag=False, dtype=jnp.float64):
        M = inducing.num_inducing
        q_mu = jnp.zeros((M, num_latent), dtype)
        if q_diag:
            q_sqrt = jnp.ones((M, num_latent), dtype)
        else:
            q_sqrt = jnp.broadcast_to(
                jnp.eye(M, dtype=dtype), (num_latent, M, M)
            )
        return cls(kernel=kernel, likelihood=likelihood, inducing=inducing,
                   q_mu=q_mu, q_sqrt=q_sqrt, whiten=whiten, q_diag=q_diag)

    @property
    def num_latent(self):
        return self.q_mu.shape[1]

    def _tril_q_sqrt(self):
        if self.q_diag:
            return self.q_sqrt
        return jnp.tril(self.q_sqrt)

    def _covariances(self, X):
        # jitter=None → the inducing object resolves a dtype-aware default
        if hasattr(self.inducing, "covariances"):
            return self.inducing.covariances(self.kernel, X, None)
        Kuu = self.inducing.Kuu(self.kernel, None)
        Kuf = self.inducing.Kuf(self.kernel, X)
        return Kuu, Kuf

    @property
    def _kuu_identity(self):
        """VOSF fast path: Kuu = I needs no Cholesky/solves (O(M) KL and
        elementwise conditional — SURVEY.md §2.2)."""
        return getattr(self.inducing, "kuu_is_identity", False)

    @precise_linalg
    def _identity_conditional(self, Kuf, Knn):
        q_sqrt = self._tril_q_sqrt()
        mean = Kuf.T @ self.q_mu
        if self.q_diag:
            extra = (q_sqrt.T[:, :, None] ** 2 * Kuf[None] ** 2).sum(1)
        else:
            SA = jnp.einsum("cmk,kn->cmn", jnp.swapaxes(q_sqrt, -1, -2), Kuf)
            extra = jnp.sum(SA**2, axis=1)
        # Knn ≡ Σ Kuf² analytically on the self-consistent VOSF path, and
        # Knn is the (approximate) PDE kernel on the untruncated-prior
        # path — both need the marginal floor (gauss.floor_marginal_variance).
        var = Knn[None, :] - jnp.sum(Kuf**2, axis=0)[None, :] + extra
        return mean, gauss.floor_marginal_variance(var, scale=Knn).T

    @precise_linalg
    def predict_f(self, X, full_cov=False):
        if self._kuu_identity and not full_cov:
            Kuf = self.inducing.Kuf(self.kernel, X)
            return self._identity_conditional(Kuf, self.kernel.Kdiag(X))
        Kuu, Kuf = self._covariances(X)
        Knn = (
            self.kernel.K(X) if full_cov else self.kernel.Kdiag(X)
        )
        return gauss.conditional(
            Kuf, Kuu, Knn, self.q_mu, self._tril_q_sqrt(),
            white=self.whiten, full_cov=full_cov,
        )

    def prior_kl(self, Kuu=None):
        q_sqrt = self._tril_q_sqrt()
        if self.whiten:
            return gauss.gauss_kl(self.q_mu, q_sqrt)
        if Kuu is None:
            Kuu = self.inducing.Kuu(self.kernel, None)
        return gauss.gauss_kl(self.q_mu, q_sqrt, K=Kuu)

    @precise_linalg
    def elbo(self, X, Y, num_data=None, key=None):
        """Evidence lower bound on a (mini)batch.

        num_data: total dataset size N for minibatch scaling (defaults to
        the batch size). key: PRNG key for Monte-Carlo likelihoods.
        """
        if self._kuu_identity:
            Knn = self.kernel.Kdiag(X)
            Kuf = self.inducing.Kuf(self.kernel, X)
            fmean, fvar = self._identity_conditional(Kuf, Knn)
            kl = gauss.gauss_kl(self.q_mu, self._tril_q_sqrt())
        else:
            if hasattr(self.inducing, "covariances_full"):
                # inducing families with a joint (Kuu, Kuf, Knn) batch
                # covariance — the joint-PSD guarantee for FD kernels
                # (see InducingSequences.covariances_full)
                Kuu, Kuf, Knn = self.inducing.covariances_full(
                    self.kernel, X, None
                )
            else:
                Knn = self.kernel.Kdiag(X)
                Kuu, Kuf = self._covariances(X)
            L = gauss.stable_cholesky(Kuu)
            fmean, fvar = gauss.conditional(
                Kuf, Kuu, Knn, self.q_mu, self._tril_q_sqrt(),
                white=self.whiten, Kmm_chol=L,
            )
            if self.whiten:
                kl = gauss.gauss_kl(self.q_mu, self._tril_q_sqrt())
            else:
                kl = gauss.gauss_kl(self.q_mu, self._tril_q_sqrt(), K_chol=L)
        var_exp = self.likelihood.variational_expectations(
            Y, fmean, fvar, key=key
        )
        batch = fmean.shape[0]
        total = batch if num_data is None else num_data
        scale = jnp.asarray(total, fmean.dtype) / batch
        return scale * jnp.sum(var_exp) - kl

    def predict_y(self, X, **kw):
        m, v = self.predict_f(X)
        return self.likelihood.predict_mean_and_var(m, v, **kw)

    def predict_log_density(self, X, Y, **kw):
        m, v = self.predict_f(X)
        return self.likelihood.predict_log_density(Y, m, v, **kw)

    @precise_linalg
    def posterior(self):
        """Precompute the posterior projections for repeated prediction.

        Reference parity: the reference's model wrapper caches the Kuu
        factors at prediction time (``gpsig/models.py`` — SURVEY.md §2.1
        Models row, §3.2) so batch-wise test-set prediction does not pay
        the O(M³) Cholesky + O(M²·L²) inducing Gram per batch.
        ``predict_f`` above recomputes both per call; the returned
        :class:`Posterior` folds everything batch-independent into

            mean  = Kufᵀ · a,            a  = L⁻ᵀ q_mu     (white)
                                          a  = Kuu⁻¹ q_mu   (unwhitened)
            var_c = Knn − kufᵀ · Q_c · kuf,
            Q_c   = L⁻ᵀ (I − S_c S_cᵀ) L⁻¹                  (white)
            Q_c   = Kuu⁻¹ − Kuu⁻¹ S_c S_cᵀ Kuu⁻¹            (unwhitened)

        so a prediction batch costs one Kuf build + C matmuls — no
        Cholesky, no triangular solves (an [M,M]·[M,B] matmul is parallel
        where a blocked triangular solve serialises).

        The VOSF / Kuu = I + diagonal-q fast path stays O(M) per point:
        Q_c is diagonal (1 − s_c²) and never materialised.
        """
        q_sqrt = self._tril_q_sqrt()
        C = self.num_latent
        if self._kuu_identity:
            if self.q_diag:
                return Posterior(
                    kernel=self.kernel, likelihood=self.likelihood,
                    inducing=self.inducing, proj_mean=self.q_mu,
                    quad=1.0 - q_sqrt**2, quad_is_diag=True,
                )
            M = self.q_mu.shape[0]
            eye = jnp.eye(M, dtype=self.q_mu.dtype)
            quad = eye[None] - jnp.einsum("cmk,cnk->cmn", q_sqrt, q_sqrt)
            return Posterior(
                kernel=self.kernel, likelihood=self.likelihood,
                inducing=self.inducing, proj_mean=self.q_mu, quad=quad,
                quad_is_diag=False,
            )
        Kuu = self.inducing.Kuu(self.kernel, None)
        L = gauss.stable_cholesky(Kuu)
        M = L.shape[0]
        eye = jnp.eye(M, dtype=L.dtype)
        Linv = jsp.linalg.solve_triangular(L, eye, lower=True)
        if self.q_diag:
            SSt = jnp.einsum("mc,mn->cmn", q_sqrt**2, eye)
        else:
            SSt = jnp.einsum("cmk,cnk->cmn", q_sqrt, q_sqrt)
        if self.whiten:
            proj_mean = Linv.T @ self.q_mu
            inner = eye[None] - SSt
            quad = jnp.einsum("nm,cnk,kp->cmp", Linv, inner, Linv)
        else:
            Kinv = Linv.T @ Linv
            proj_mean = Kinv @ self.q_mu
            quad = Kinv[None] - jnp.einsum(
                "mn,cnk,kp->cmp", Kinv, SSt, Kinv
            )
        return Posterior(
            kernel=self.kernel, likelihood=self.likelihood,
            inducing=self.inducing, proj_mean=proj_mean, quad=quad,
            quad_is_diag=False,
        )


@struct.dataclass
class Posterior:
    """Batch-independent SVGP posterior projections (see
    :meth:`SVGP.posterior`). A pytree — jit a function taking it as an
    argument and batch predictions reuse the cached projections."""

    kernel: Any
    likelihood: Any
    inducing: Any
    proj_mean: jnp.ndarray  # [M, C]
    quad: jnp.ndarray  # [C, M, M], or [M, C] diagonal (VOSF fast path)
    quad_is_diag: bool = struct.field(pytree_node=False, default=False)

    @precise_linalg
    def predict_f(self, X, full_cov=False):
        Kuf = self.inducing.Kuf(self.kernel, X)  # [M, N]
        mean = Kuf.T @ self.proj_mean  # [N, C]
        if full_cov:
            Knn = self.kernel.K(X)
            if self.quad_is_diag:
                red = jnp.einsum(
                    "mn,mc,mk->cnk", Kuf, self.quad, Kuf
                )
            else:
                red = jnp.einsum("mn,cmp,pk->cnk", Kuf, self.quad, Kuf)
            return mean, Knn[None] - red
        Knn = self.kernel.Kdiag(X)
        if self.quad_is_diag:
            red = jnp.einsum("mn,mc->cn", Kuf**2, self.quad)
        else:
            QK = jnp.einsum("cmp,pn->cmn", self.quad, Kuf)
            red = jnp.sum(Kuf[None] * QK, axis=1)  # [C, N]
        # Same subtraction structure as gauss.conditional — approximate
        # (FD-PDE) kernels and identity features need the marginal floor
        # here too (full_cov matrices are exact-kernel-only; see
        # gauss.floor_marginal_variance for the policy).
        var = gauss.floor_marginal_variance(Knn[None, :] - red, scale=Knn)
        return mean, var.T

    def predict_y(self, X, **kw):
        m, v = self.predict_f(X)
        return self.likelihood.predict_mean_and_var(m, v, **kw)

    def predict_log_density(self, X, Y, **kw):
        m, v = self.predict_f(X)
        return self.likelihood.predict_log_density(Y, m, v, **kw)
