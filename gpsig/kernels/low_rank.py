"""Low-rank signature kernel: explicit feature maps, O(N·L·c) Grams.

Reference parity: the ``low_rank=True`` configuration of
``gpsig/kernels.py::SignatureKernel`` with ``num_components``,
``rank_bound`` and ``sparsity`` (SURVEY.md §2.1). Implemented as its own
dataclass (the dense and low-rank paths share the augmentation logic but no
state): ``K ≈ Σ_m σ²σ_m² F_m(X) F_m(Y)ᵀ`` with the per-level features of
``gpsig.ops.low_rank``.

The feature recursion is a chain of [N·L, c]×[c…] elementwise ops + one
final [N, c_tot] × [c_tot, N'] matmul — the memory wall of the
dense path (O(N²L²)) disappears.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
from gpsig import struct

from gpsig import params as pr
from gpsig.kernels import static_kernels as sk
from gpsig.ops import low_rank as lr


@struct.dataclass
class LowRankSignatureKernel:
    base: Any
    raw_sigma: jnp.ndarray
    raw_variances: jnp.ndarray  # [num_levels+1]
    raw_lengthscales: jnp.ndarray | None
    landmarks: jnp.ndarray  # [n_landmarks, d] Nyström landmarks
    pair_indices: Any  # tuple of [2, r] int arrays (levels 2..nl) or None
    num_features: int = struct.field(pytree_node=False)
    num_levels: int = struct.field(pytree_node=False)
    num_components: int = struct.field(pytree_node=False)
    normalization: bool = struct.field(pytree_node=False, default=True)
    difference: bool = struct.field(pytree_node=False, default=True)

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
    def level_variances(self):
        return self.sigma * self.variances

    def _as_sequences(self, X):
        X = jnp.asarray(X)
        if X.ndim == 2:
            N, Ld = X.shape
            return X.reshape(N, Ld // self.num_features, self.num_features)
        return X

    def feature_levels(self, X):
        """Per-level sequence features, list of [N, c_m] for m=1..nl
        (normalised per level when ``normalization``)."""
        Xs = self._as_sequences(X)
        ell = self.lengthscales
        if ell is not None:
            Xs = Xs / ell
            Zl = self.landmarks / ell
        else:
            Zl = self.landmarks
        phi = lr.nystrom_map(Xs, Zl, self.base, self.num_components)
        dphi = jnp.diff(phi, axis=-2) if self.difference else phi
        feats = lr.signature_features(
            dphi, self.num_levels, self.pair_indices
        )
        if self.normalization:
            feats = [
                f / jnp.sqrt(jnp.maximum(jnp.sum(f * f, -1, keepdims=True),
                                         1e-30))
                for f in feats
            ]
        return feats

    def feature(self, X):
        """Stacked weighted feature map Φ(X): [N, 1 + Σ c_m] with
        K(X, Y) = Φ(X) Φ(Y)ᵀ exactly (constant level included)."""
        feats = self.feature_levels(X)
        w = jnp.sqrt(self.level_variances)
        N = feats[0].shape[0]
        cols = [jnp.full((N, 1), w[0], feats[0].dtype)]
        for m, f in enumerate(feats, start=1):
            cols.append(w[m] * f)
        return jnp.concatenate(cols, axis=-1)

    def K(self, X, X2=None):
        F1 = self.feature(X)
        F2 = F1 if X2 is None else self.feature(X2)
        return F1 @ F2.T

    def Kdiag(self, X):
        F = self.feature(X)
        return jnp.sum(F * F, axis=-1)


def LowRankSignatureRBF(
    key,
    X_example,
    num_features,
    num_levels,
    num_components=64,
    rank_bound=None,
    sparsity="sqrt",
    n_landmarks=None,
    lengthscales=1.0,
    sigma=1.0,
    variances=None,
    normalization=True,
    difference=True,
    dtype=jnp.float64,
):
    """Construct a low-rank RBF signature kernel with data-driven landmarks.

    ``sparsity='sqrt'`` (the reference default): rank_bound defaults to
    ``num_components`` so each level's sketch keeps c columns out of c²
    (≈√ of the full product dimension squared)."""
    X = jnp.asarray(X_example)
    if X.ndim == 2:
        X = X.reshape(X.shape[0], -1, num_features)
    steps = X.reshape(-1, num_features)
    n_landmarks = n_landmarks or min(2 * num_components, steps.shape[0])
    k_lm, k_idx = jax.random.split(key)
    sel = jax.random.choice(k_lm, steps.shape[0], (n_landmarks,),
                            replace=False)
    landmarks = steps[sel].astype(dtype)
    if rank_bound is None:
        rank_bound = (
            num_components if sparsity == "sqrt" else num_components**2
        )
    pair_indices = []
    c_prev = num_components
    for m in range(2, num_levels + 1):
        k_idx, sub = jax.random.split(k_idx)
        full = c_prev * num_components
        if rank_bound < full:
            pair_indices.append(
                lr.draw_pair_indices(sub, num_components, c_prev, rank_bound)
            )
            c_prev = rank_bound
        else:
            pair_indices.append(None)
            c_prev = full
    nl1 = num_levels + 1
    variances = (
        jnp.ones((nl1,), dtype)
        if variances is None
        else jnp.broadcast_to(jnp.asarray(variances, dtype), (nl1,))
    )
    ell = jnp.broadcast_to(jnp.asarray(lengthscales, dtype), (num_features,))
    return LowRankSignatureKernel(
        base=sk.RBFBase(),
        raw_sigma=pr.inv_positive(jnp.asarray(sigma, dtype)),
        raw_variances=pr.inv_positive(variances),
        raw_lengthscales=pr.inv_positive(ell),
        landmarks=landmarks,
        pair_indices=tuple(pair_indices),
        num_features=num_features,
        num_levels=num_levels,
        num_components=num_components,
        normalization=normalization,
        difference=difference,
    )
