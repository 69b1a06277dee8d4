"""Truncated signature kernels over sequences (the reference's core object).

Reference parity: ``gpsig/kernels.py::SignatureKernel`` (SURVEY.md §2.1) with
``__init__(input_dim, num_features, num_levels, order, variances,
lengthscales, normalization, difference, num_lags, low_rank, ...)`` and the
public surface ``K``, ``Kdiag``, ``K_tens``, ``K_tens_vs_seq``,
``K_tens_diag`` plus the base-kernel subclasses ``SignatureLinear``,
``SignatureRBF``, ``SignaturePoly``, ``SignatureCosine``. The reference was
unreadable at build time (empty mount); semantics are reconstructed from
Toth & Oberhauser (ICML 2020) and validated against brute-force oracles.

Design notes
------------
- The kernel object is a ``gpsig.struct`` dataclass: its pytree leaves are
  the *unconstrained* parameters (softplus/logistic transforms as in GPflow
  1.x), so the whole model jits/grads/shards as one pytree.
- Sequence axes are kept trailing ([..., L1, L2]) so the DP recursions are
  elementwise ops and cumsums that XLA fuses; the base-kernel Gram is one
  matmul over the flattened step sets.
- Sequences may be passed flattened [N, L*d] (the reference's convention) or
  as [N, L, d]; `num_features` disambiguates.

Options
-------
- ``num_levels``: truncation level; per-level variances [num_levels+1]
  (level 0 = constant) plus a global variance.
- ``order``: per-step tensor-exponential truncation (1 = first-order
  recursion; >= num_levels = exact piecewise-linear signature).
- ``normalization``: per-level normalisation k̃_m(x,y) =
  k_m(x,y)/√(k_m(x,x)k_m(y,y)) — applied to the *sequence* feature side only
  (inducing tensors are free parameters and are not normalised).
- ``difference``: if True (default) the DP runs on the double-differenced
  increment Gram; if False on the raw step Gram (the reference's flag).
- ``num_lags``: appends lagged channel copies with learnable fractional lag
  positions (logistic-transformed) and positive per-copy mixing weights γ.

Engines
-------
``engine='auto'`` (default) runs the fused Triton Gram kernel
(`ops/pallas/fused_gram.py` — base kernel, differencing and DP in one pass,
never materialising the [N1, N2, L, L] increment tensor) wherever the work
lowers for CUDA and the kernel applies: ``order == 1``,
``difference == True`` and an RBF or Linear base (lags are fine — lag
augmentation happens upstream). It serves the Gram ``K``, the normalisation
diagonal and hence every such model's Kuu/Kuf with inducing sequences.
Everything else, and all work lowered for the CPU, takes the plain XLA
path: ``ops/signature.py``'s recursions over the increment tensor.
``engine='xla'`` forces the plain path; ``engine='pallas'`` forces the
kernel, in the Pallas interpreter on the CPU (how tests reach it).
Gradients of the fused path recompute through the XLA path.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from gpsig import params as pr
from gpsig import struct
from gpsig.kernels import static_kernels as sk
from gpsig.ops import signature as sigops
from gpsig.ops.pallas import fused_gram


@struct.dataclass
class SignatureKernel:
    base: Any  # base-kernel pytree (LinearBase/RBFBase/PolyBase/CosineBase)
    raw_sigma: jnp.ndarray  # scalar, global variance σ²
    raw_variances: jnp.ndarray  # [num_levels+1] per-level variances σ_m²
    raw_lengthscales: jnp.ndarray | None  # [d] ARD, None = no scaling
    raw_lags: jnp.ndarray | None  # [num_lags] in (0, 1) via logistic
    raw_gamma: jnp.ndarray | None  # [1+num_lags] positive mixing weights
    num_features: int = struct.field(pytree_node=False)
    num_levels: int = struct.field(pytree_node=False)
    order: int = struct.field(pytree_node=False, default=1)
    normalization: bool = struct.field(pytree_node=False, default=True)
    difference: bool = struct.field(pytree_node=False, default=True)
    num_lags: int = struct.field(pytree_node=False, default=0)
    #: 'auto' (fused kernel where it applies and the work lowers for
    #: CUDA), 'xla' or 'pallas' (force the fused kernel; interpreted on
    #: the CPU)
    engine: str = struct.field(pytree_node=False, default="auto")
    #: XLA-path memory control: compute K in row blocks of this many
    #: sequences (0 = single pass). The fused kernel ignores it (it never
    #: materialises the [N², L²] tensor).
    row_block: int = struct.field(pytree_node=False, default=0)

    # -- constrained views ------------------------------------------------
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
    def lags(self):
        if self.raw_lags is None:
            return None
        return pr.logistic(self.raw_lags)

    @property
    def gamma(self):
        if self.raw_gamma is None:
            return None
        return pr.positive(self.raw_gamma)

    @property
    def level_variances(self):
        """σ² σ_m², [num_levels+1]."""
        return self.sigma * self.variances

    # -- input handling ---------------------------------------------------
    def _as_sequences(self, X):
        """[N, L*d] or [N, L, d] → [N, L, d]."""
        X = jnp.asarray(X)
        if X.ndim == 2:
            N, Ld = X.shape
            d = self.num_features
            if Ld % d:
                raise ValueError(
                    f"flattened length {Ld} not divisible by num_features {d}"
                )
            X = X.reshape(N, Ld // d, d)
        return X

    def _augment(self, X):
        """Apply ARD lengthscale scaling and lag augmentation.

        [N, L, d] → [N, L, d*(1+num_lags)] (scaled)."""
        ell = self.lengthscales
        if ell is not None:
            X = X / ell
        if self.num_lags == 0:
            return X
        L = X.shape[-2]
        gamma = self.gamma
        blocks = [gamma[0] * X]
        for s in range(self.num_lags):
            shift = self.lags[s] * (L - 1)
            pos = jnp.arange(L, dtype=X.dtype) - shift
            pos = jnp.clip(pos, 0.0, L - 1)
            i0 = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, L - 2)
            frac = pos - i0.astype(X.dtype)
            x0 = jnp.take(X, i0, axis=-2)
            x1 = jnp.take(X, i0 + 1, axis=-2)
            lagged = x0 + frac[:, None] * (x1 - x0)
            blocks.append(gamma[1 + s] * lagged)
        return jnp.concatenate(blocks, axis=-1)

    # -- sequence-vs-sequence ---------------------------------------------
    def _increment_matrix(self, X, Y):
        """Base Gram over all step pairs, optionally double-differenced.

        X: [N1, L1, d'], Y: [N2, L2, d'] → M [N1, N2, l1, l2]."""
        N1, L1, d = X.shape
        N2, L2, _ = Y.shape
        G = self.base.gram(X.reshape(N1 * L1, d), Y.reshape(N2 * L2, d))
        G = G.reshape(N1, L1, N2, L2).transpose(0, 2, 1, 3)
        return sigops.incremental_gram(G) if self.difference else G

    def _increment_matrix_diag(self, X):
        """Per-sequence self increment matrices: [N, l, l]."""
        G = self.base.gram(X, X)  # batched: [N, L, L]
        return sigops.incremental_gram(G) if self.difference else G

    def _fused_rbf(self):
        """rbf flag when the fused Gram kernel may serve this configuration
        (engine not 'xla'; order 1, difference, RBF/Linear base), else
        None."""
        if self.engine == "xla" or not (self.order == 1 and self.difference):
            return None
        if isinstance(self.base, sk.RBFBase):
            return True
        if isinstance(self.base, sk.LinearBase):
            return False
        return None

    def _dispatch(self, fused, plain, *args):
        """``fused(*args, num_levels, rbf, interpret)`` where it applies,
        ``plain(*args)`` otherwise. Under 'auto' the choice is made per
        lowering platform (``lax.platform_dependent``): the compiled kernel
        where the computation lowers for CUDA, the plain path elsewhere —
        also for CPU work in a process whose default backend is the GPU."""
        rbf = self._fused_rbf()
        if rbf is None:
            return plain(*args)
        nl = self.num_levels
        if self.engine == "pallas":
            # the Pallas interpreter stands in for the GPU compiler on CPU
            interpret = jax.default_backend() == "cpu"
            return fused(*args, nl, rbf, interpret)
        return jax.lax.platform_dependent(
            *args, cuda=lambda *a: fused(*a, nl, rbf), default=plain)

    def _K_levels(self, X, Y):
        return self._dispatch(fused_gram.fused_gram_levels,
                              self._K_levels_plain, X, Y)

    def _K_levels_diag(self, X):
        def plain(X):
            M = self._increment_matrix_diag(X)
            return sigops.signature_kern(M, self.num_levels, self.order)

        return self._dispatch(fused_gram.fused_diag_levels, plain, X)

    def _K_levels_plain(self, X, Y):
        """XLA path, in row blocks of ``row_block`` sequences if set."""
        def levels(xb):
            M = self._increment_matrix(xb, Y)
            return sigops.signature_kern(M, self.num_levels, self.order)

        rb = self.row_block
        if rb <= 0 or X.shape[0] <= rb:
            return levels(X)
        N1 = X.shape[0]
        pad = (-N1) % rb
        Xp = jnp.concatenate([X, X[:pad]], axis=0) if pad else X
        out = jax.lax.map(levels, Xp.reshape(-1, rb, *X.shape[1:]))
        out = jnp.moveaxis(out, 1, 0).reshape(
            self.num_levels + 1, -1, Y.shape[0]
        )
        return out[:, :N1]

    def K(self, X, X2=None, return_levels=False):
        """Signature-kernel Gram matrix [N1, N2]."""
        Xs = self._augment(self._as_sequences(X))
        sym = X2 is None
        Ys = Xs if sym else self._augment(self._as_sequences(X2))
        levels = self._K_levels(Xs, Ys)  # [nl+1, N1, N2]
        if self.normalization:
            dx = self._K_levels_diag(Xs)
            dy = dx if sym else self._K_levels_diag(Ys)
            levels = _normalize_levels(levels, dx[:, :, None], dy[:, None, :])
        w = self.level_variances
        weighted = w[:, None, None] * levels
        return weighted if return_levels else jnp.sum(weighted, axis=0)

    def seq_covariances(self, Z, X):
        """(K(Z,Z), K(Z,X)) sharing the diag-normalisation work.

        The reference's combined-covariance helpers compute (Kuu, Kuf) in
        one pass (SURVEY.md §2.1); here the Z-side diagonal recursion — the
        O(M·L²) piece — is computed once instead of twice."""
        Zs = self._augment(self._as_sequences(Z))
        Xs = self._augment(self._as_sequences(X))
        zz = self._K_levels(Zs, Zs)
        zx = self._K_levels(Zs, Xs)
        if self.normalization:
            dz = self._K_levels_diag(Zs)
            dx = self._K_levels_diag(Xs)
            zz = _normalize_levels(zz, dz[:, :, None], dz[:, None, :])
            zx = _normalize_levels(zx, dz[:, :, None], dx[:, None, :])
        w = self.level_variances
        return (
            jnp.sum(w[:, None, None] * zz, axis=0),
            jnp.sum(w[:, None, None] * zx, axis=0),
        )

    def Kdiag(self, X, return_levels=False):
        X = self._as_sequences(X)
        N = X.shape[0]
        w = self.level_variances
        if self.normalization:
            # per-level normalisation makes every level's diag exactly 1 —
            # Kdiag is the constant σ²Σσ_m², no recursion needed.
            ones = jnp.ones((self.num_levels + 1, N), w.dtype)
            weighted = w[:, None] * ones
            return weighted if return_levels else jnp.sum(weighted, axis=0)
        Xs = self._augment(X)
        levels = self._K_levels_diag(Xs)  # [nl+1, N]
        weighted = w[:, None] * levels
        return weighted if return_levels else jnp.sum(weighted, axis=0)

    # -- inducing-tensor algebra ------------------------------------------
    # Z layout: [num_tensors, F, d] with F = num_levels(num_levels+1)/2
    # (level-major factor stacking), or [num_tensors, F, 2, d] when
    # increments=True (each factor an RKHS increment φ(z_b) - φ(z_a)).

    def _factor_gram_matched(self, Z1, Z2, increments):
        """Matched-position factor Grams: [T1, T2, F].

        Only matched factor positions are needed (⟨z^m, w^m⟩ = Π_a k(z_a, w_a)
        pairs factor a with factor a), so this broadcasts `matched` rather
        than building the full [T1·F, T2·F] Gram."""
        if increments:
            # [T1,1,F,2,1,d] x [1,T2,F,1,2,d] -> [T1,T2,F,2,2]
            G = self.base.matched(
                Z1[:, None, :, :, None, :], Z2[None, :, :, None, :, :]
            )
            return (
                G[..., 1, 1] - G[..., 1, 0] - G[..., 0, 1] + G[..., 0, 0]
            )
        return self.base.matched(Z1[:, None], Z2[None, :])

    def _scale_tensors(self, Z):
        ell = self.lengthscales
        if ell is None:
            return Z
        if self.num_lags > 0:
            # factors live in the lag-augmented feature space R^{d*(1+lags)}
            d = self.num_features
            reps = Z.shape[-1] // d
            ell = jnp.tile(ell, reps)
            gam = jnp.repeat(self.gamma, d)
            return Z * gam / ell
        return Z / ell

    def K_tens(self, Z, increments=False, return_levels=False):
        """Gram of inducing tensors: [nl(+1 levels stacked), T, T]."""
        Zs = self._scale_tensors(Z)
        G = self._factor_gram_matched(Zs, Zs, increments)
        levels = sigops.signature_kern_tens(G, self.num_levels)  # [nl+1,T,T]
        w = self.level_variances
        weighted = w[:, None, None] * levels
        # level 0 of tensors is excluded (tensors span levels 1..num_levels)
        weighted = weighted[1:]
        return weighted if return_levels else jnp.sum(weighted, axis=0)

    def K_tens_diag(self, Z, increments=False, return_levels=False):
        Zs = self._scale_tensors(Z)
        if increments:
            G = self.base.matched(
                Zs[:, :, :, None, :], Zs[:, :, None, :, :]
            )  # [T, F, 2, 2]
            G = G[..., 1, 1] - G[..., 1, 0] - G[..., 0, 1] + G[..., 0, 0]
        else:
            G = self.base.matched(Zs, Zs)  # [T, F]
        diag = sigops.signature_kern_tens(G, self.num_levels)  # [nl+1, T]
        w = self.level_variances
        weighted = (w[:, None] * diag)[1:]
        return weighted if return_levels else jnp.sum(weighted, axis=0)

    def K_tens_vs_seq(self, Z, X, increments=False, return_levels=False):
        """Cross-covariance ⟨z, S(x)⟩: [T, N]."""
        Zs = self._scale_tensors(Z)
        Xs = self._augment(self._as_sequences(X))
        N, L, d = Xs.shape
        if increments:
            T, F = Zs.shape[0], Zs.shape[1]
            G = self.base.gram(Zs.reshape(T * F * 2, d), Xs.reshape(N * L, d))
            G = G.reshape(T, F, 2, N, L)
            G = G[:, :, 1] - G[:, :, 0]  # difference within the factor pair
        else:
            T, F = Zs.shape[0], Zs.shape[1]
            G = self.base.gram(Zs.reshape(T * F, d), Xs.reshape(N * L, d))
            G = G.reshape(T, F, N, L)
        if self.difference:
            U = G[..., 1:] - G[..., :-1]  # difference along the sequence
        else:
            U = G
        U = jnp.moveaxis(U, 1, 2)  # [T, N, F, l]
        levels = sigops.signature_kern_tens_vs_seq(
            U, self.num_levels, self.order
        )  # [nl+1, T, N]
        return self._finish_tens_vs_seq(levels, Xs, return_levels)

    def _finish_tens_vs_seq(self, levels, Xs, return_levels):
        """Shared normalisation + level weighting for K_tens_vs_seq."""
        if self.normalization:
            dx = self._K_levels_diag(Xs)  # [nl+1, N]
            norm = jnp.sqrt(jnp.maximum(dx, 1e-30))
            levels = levels / norm[:, None, :]
        w = self.level_variances
        weighted = (w[:, None, None] * levels)[1:]
        return weighted if return_levels else jnp.sum(weighted, axis=0)


def _normalize_levels(levels, dx, dy, eps=1e-30):
    """k̃_m = k_m / √(k_m(x,x) k_m(y,y)); level 0 passes through unchanged."""
    norm = jnp.sqrt(jnp.maximum(dx, eps) * jnp.maximum(dy, eps))
    out = levels / norm
    return out.at[0].set(levels[0])


# ---------------------------------------------------------------------------
# Constructors mirroring the reference's subclass names.
# ---------------------------------------------------------------------------


def _make(
    base,
    num_features,
    num_levels,
    order=1,
    normalization=True,
    difference=True,
    num_lags=0,
    sigma=1.0,
    variances=None,
    lengthscales=None,
    dtype=jnp.float64,
    engine="auto",
):
    nl1 = num_levels + 1
    if variances is None:
        variances = jnp.ones((nl1,), dtype)
    else:
        variances = jnp.broadcast_to(jnp.asarray(variances, dtype), (nl1,))
    raw_ell = None
    if lengthscales is not None:
        ell = jnp.broadcast_to(
            jnp.asarray(lengthscales, dtype), (num_features,)
        )
        raw_ell = pr.inv_positive(ell)
    raw_lags = None
    raw_gamma = None
    if num_lags > 0:
        init = jnp.linspace(0.1, 0.5, num_lags).astype(dtype)
        raw_lags = pr.inv_logistic(init)
        raw_gamma = pr.inv_positive(jnp.ones((1 + num_lags,), dtype))
    return SignatureKernel(
        base=base,
        raw_sigma=pr.inv_positive(jnp.asarray(sigma, dtype)),
        raw_variances=pr.inv_positive(variances),
        raw_lengthscales=raw_ell,
        raw_lags=raw_lags,
        raw_gamma=raw_gamma,
        num_features=num_features,
        num_levels=num_levels,
        order=order,
        normalization=normalization,
        difference=difference,
        num_lags=num_lags,
        engine=engine,
    )


def SignatureLinear(num_features, num_levels, lengthscales=1.0, **kw):
    return _make(sk.LinearBase(), num_features, num_levels,
                 lengthscales=lengthscales, **kw)


def SignatureRBF(num_features, num_levels, lengthscales=1.0, **kw):
    return _make(sk.RBFBase(), num_features, num_levels,
                 lengthscales=lengthscales, **kw)


def SignaturePoly(num_features, num_levels, lengthscales=1.0, offset=1.0,
                  degree=2, dtype=jnp.float64, **kw):
    base = sk.PolyBase.create(offset=offset, degree=degree, dtype=dtype)
    return _make(base, num_features, num_levels, lengthscales=lengthscales,
                 dtype=dtype, **kw)


def SignatureCosine(num_features, num_levels, lengthscales=1.0, **kw):
    return _make(sk.CosineBase(), num_features, num_levels,
                 lengthscales=lengthscales, **kw)
