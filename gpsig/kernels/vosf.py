"""Explicit-signature feature kernel + orthogonal inducing features (VOSF).

Reference parity: the fork's *variational orthogonal signature features*
(SURVEY.md §2.2; Lemercier et al., ICML 2021 §4): inter-domain inducing
variables that are rescaled signature coordinates, making ``Kuu = I`` so the
KL and natural-gradient costs collapse from O(M³) to O(M) — the mechanism
behind the ~1M-series experiment.

Construction here: the prior is f(x) = Σ_I w_I ψ_I(x), w ~ N(0, I), where
ψ stacks level-m signature coordinates scaled by σ·σ_m (optionally per-level
normalised). Then k(x, y) = Ψ(x)ᵀΨ(y) is the truncated (linear-lift)
signature kernel, u_I = w_I gives exactly Kuu = I and Kuf = Ψ(X)ᵀ, and a
diagonal q is the natural variational family (one GP per class).
"""

from __future__ import annotations

import jax.numpy as jnp
from gpsig import struct

from gpsig import params as pr
from gpsig.ops import explicit as ex


@struct.dataclass
class ExplicitSignatureKernel:
    """Truncated signature kernel via explicit coordinates (linear lift)."""

    raw_sigma: jnp.ndarray
    raw_variances: jnp.ndarray  # [num_levels+1]
    raw_lengthscales: jnp.ndarray | None  # [d]
    num_features: int = struct.field(pytree_node=False)
    num_levels: int = struct.field(pytree_node=False)
    normalization: bool = struct.field(pytree_node=False, default=True)

    @classmethod
    def create(cls, num_features, num_levels, lengthscales=1.0, sigma=1.0,
               variances=None, normalization=True, dtype=jnp.float64):
        nl1 = num_levels + 1
        variances = (
            jnp.ones((nl1,), dtype) if variances is None
            else jnp.broadcast_to(jnp.asarray(variances, dtype), (nl1,))
        )
        raw_ell = None
        if lengthscales is not None:
            ell = jnp.broadcast_to(jnp.asarray(lengthscales, dtype),
                                   (num_features,))
            raw_ell = pr.inv_positive(ell)
        return cls(
            raw_sigma=pr.inv_positive(jnp.asarray(sigma, dtype)),
            raw_variances=pr.inv_positive(variances),
            raw_lengthscales=raw_ell,
            num_features=num_features,
            num_levels=num_levels,
            normalization=normalization,
        )

    @property
    def sigma(self):
        return pr.positive(self.raw_sigma)

    @property
    def variances(self):
        return pr.positive(self.raw_variances)

    @property
    def lengthscales(self):
        if self.raw_lengthscales is None:
            return None
        return pr.positive(self.raw_lengthscales)

    @property
    def num_features_total(self):
        return ex.signature_dim(self.num_features, self.num_levels)

    def _as_sequences(self, X):
        X = jnp.asarray(X)
        if X.ndim == 2:
            N, Ld = X.shape
            return X.reshape(N, Ld // self.num_features, self.num_features)
        return X

    def feature(self, X):
        """Ψ(X): [N, 1 + Σ_m d^m]; k(x,y) = ⟨Ψ(x), Ψ(y)⟩."""
        Xs = self._as_sequences(X)
        ell = self.lengthscales
        if ell is not None:
            Xs = Xs / ell
        levels = ex.truncated_signature(Xs, self.num_levels)
        if self.normalization:
            levels = [
                f / jnp.sqrt(jnp.maximum(jnp.sum(f * f, -1, keepdims=True),
                                         1e-30))
                for f in levels
            ]
        w = jnp.sqrt(self.sigma * self.variances)
        N = Xs.shape[0]
        cols = [jnp.full((N, 1), w[0], Xs.dtype)]
        for m, f in enumerate(levels, start=1):
            cols.append(w[m] * f)
        return jnp.concatenate(cols, axis=-1)

    def K(self, X, X2=None):
        F1 = self.feature(X)
        F2 = F1 if X2 is None else self.feature(X2)
        return F1 @ F2.T

    def Kdiag(self, X):
        F = self.feature(X)
        return jnp.sum(F * F, axis=-1)


@struct.dataclass
class OrthogonalSignatureFeatures:
    """VOSF inducing family: Kuu = I exactly, Kuf = Ψ(X)ᵀ.

    Use with ``SVGP(..., q_diag=True, whiten=True)``: whitened and
    unwhitened coincide, the KL is diagonal-Gaussian vs N(0, I) (O(M)),
    and the natural-gradient update is elementwise.

    Two priors are supported (``for_kernel`` dispatches on the kernel):

    * :class:`ExplicitSignatureKernel` — the self-consistent truncated
      lift: the prior *is* k = ΨᵀΨ, so the conditional's ``Knn − Σ Kuf²``
      cancels exactly (rounding noise around zero, floored).
    * :class:`~gpsig.kernels.pde.UntruncatedSignatureKernel` — the
      reference SigGPDE model (SURVEY.md §2.2 row 3): the prior is the
      untruncated PDE kernel, ``Kuf`` = the first ``feature_levels`` of
      its Mercer expansion (``UntruncatedSignatureKernel.feature``), and
      the truncation gap ``Knn − Σ Kuf² ≥ 0`` is genuine prior variance
      mass outside the inducing span — the model the fork's 1M-series
      SITS experiment trains.
    """

    num_inducing: int = struct.field(pytree_node=False)
    #: truncation level of the feature set under the untruncated prior;
    #: None = the kernel computes its own features (ExplicitSignatureKernel)
    feature_levels: int | None = struct.field(pytree_node=False,
                                              default=None)

    kuu_is_identity = True

    @classmethod
    def for_kernel(cls, kernel, num_levels=None):
        """Features for ``kernel``. For the untruncated (PDE) kernel pass
        ``num_levels`` — the signature truncation level of the inducing
        set (M = 1 + Σ_{m≤num_levels} d^m)."""
        if isinstance(kernel, ExplicitSignatureKernel):
            if num_levels is not None and num_levels != kernel.num_levels:
                raise ValueError(
                    "ExplicitSignatureKernel carries its own truncation "
                    f"level ({kernel.num_levels}); num_levels must be "
                    "omitted or equal"
                )
            return cls(num_inducing=kernel.num_features_total)
        if num_levels is None:
            raise ValueError(
                "num_levels is required under the untruncated prior (it "
                "sets the inducing truncation level)"
            )
        M = ex.signature_dim(kernel.num_features, num_levels)
        return cls(num_inducing=M, feature_levels=num_levels)

    def Kuu(self, kernel, jitter=None):
        del jitter
        return jnp.eye(self.num_inducing, dtype=kernel.raw_sigma.dtype)

    def Kuf(self, kernel, X):
        if self.feature_levels is not None:
            return kernel.feature(X, self.feature_levels).T
        return kernel.feature(X).T
