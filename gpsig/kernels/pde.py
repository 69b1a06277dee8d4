"""Untruncated signature kernel (SigGPDE path) as a kernel object.

Reference parity: ``gpsig/kernels_pde.py::UntruncSignatureKernel`` backed by
the fork's CUDA wavefront op (SURVEY.md §2.2/§3.4). Here the solver is the
wavefront `lax.scan` of ``gpsig.ops.goursat`` with adjoint-PDE gradients; ``dyadic_order`` refines the finite-difference grid
2^o× per step.

Numerical note: the finite-difference solution is only *approximately* PSD
as a Gram matrix — at ``dyadic_order=0`` on short/rough sequences negative
eigenvalues of order 1e-3 can appear (they shrink rapidly with refinement).
Symmetric Grams can be eigenvalue-floored via a straight-through
projection (value exactly PSD with min eig >= psd_floor; gradients flow
through the unprojected symmetric Gram, so training is unaffected by the
eigh). The projection is O(N³) — intended for inducing-sized symmetric
Grams, which is exactly where chol failures bite.

``psd_floor`` semantics: ``None`` (the default) = *auto* — plain ``K(X)``
Grams are untouched, but the dedicated Kuu entry point ``K_sym_psd``
(dispatched by ``InducingSequences``) always projects, so an
inducing-sequence SVGP on this kernel is chol-safe out of the box at any
``dyadic_order``. An explicit ``psd_floor=0.0`` disables the guard
entirely; ``psd_floor > 0`` additionally projects every symmetric ``K(X)``
at that floor (the pre-round-3 opt-in behavior).
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
from gpsig import struct

from gpsig import params as pr
from gpsig.kernels import static_kernels as sk
from gpsig.ops import goursat
from gpsig.ops.signature import incremental_gram


def _psd_project(K, floor):
    """Straight-through eigenvalue floor: value = V·max(w, floor)·Vᵀ of the
    symmetrized K (exactly PSD), gradient = gradient of the symmetrized K
    (the eigh never enters AD, so degenerate eigenvalues are harmless)."""
    Ks = 0.5 * (K + K.T)
    w, V = jnp.linalg.eigh(jax.lax.stop_gradient(Ks))
    proj = (V * jnp.maximum(w, floor)) @ V.T
    proj = 0.5 * (proj + proj.T)
    return Ks + jax.lax.stop_gradient(proj - Ks)


@struct.dataclass
class UntruncatedSignatureKernel:
    base: Any
    raw_sigma: jnp.ndarray
    raw_lengthscales: jnp.ndarray | None
    num_features: int = struct.field(pytree_node=False)
    dyadic_order: int = struct.field(pytree_node=False, default=0)
    normalization: bool = struct.field(pytree_node=False, default=False)
    row_block: int = struct.field(pytree_node=False, default=0)
    #: None = auto (K_sym_psd projects, K does not); 0.0 = guard off;
    #: >0 → every symmetric Gram (X2=None) is eigenvalue-floored by a
    #: straight-through PSD projection (see module docstring)
    psd_floor: float | None = struct.field(pytree_node=False, default=None)

    @classmethod
    def create(cls, num_features, base=None, lengthscales=1.0, sigma=1.0,
               dyadic_order=0, normalization=False, row_block=0,
               psd_floor=None, dtype=jnp.float64):
        raw_ell = None
        if lengthscales is not None:
            ell = jnp.broadcast_to(jnp.asarray(lengthscales, dtype),
                                   (num_features,))
            raw_ell = pr.inv_positive(ell)
        return cls(
            base=base if base is not None else sk.LinearBase(),
            raw_sigma=pr.inv_positive(jnp.asarray(sigma, dtype)),
            raw_lengthscales=raw_ell,
            num_features=num_features,
            dyadic_order=dyadic_order,
            normalization=normalization,
            row_block=row_block,
            psd_floor=psd_floor,
        )

    @property
    def sigma(self):
        return pr.positive(self.raw_sigma)

    @property
    def lengthscales(self):
        if self.raw_lengthscales is None:
            return None
        return pr.positive(self.raw_lengthscales)

    def _as_sequences(self, X):
        X = jnp.asarray(X)
        if X.ndim == 2:
            N, Ld = X.shape
            return X.reshape(N, Ld // self.num_features, self.num_features)
        return X

    def _scaled(self, X):
        Xs = self._as_sequences(X)
        ell = self.lengthscales
        return Xs if ell is None else Xs / ell

    def _solve_pairs(self, X, Y):
        """k_sig for all pairs: [N1, N2]."""
        N1, L1, d = X.shape
        N2, L2, _ = Y.shape
        G = self.base.gram(X.reshape(N1 * L1, d), Y.reshape(N2 * L2, d))
        G = G.reshape(N1, L1, N2, L2).transpose(0, 2, 1, 3)
        inc = incremental_gram(G)
        return goursat.signature_kernel_pde(inc, self.dyadic_order)

    def _solve_rows_blocked(self, X, Y):
        if self.row_block <= 0 or X.shape[0] <= self.row_block:
            return self._solve_pairs(X, Y)
        B = self.row_block
        N1 = X.shape[0]
        pad = (-N1) % B
        Xp = jnp.concatenate([X, X[:pad]], axis=0) if pad else X
        blocks = Xp.reshape(-1, B, *X.shape[1:])
        out = jax.lax.map(lambda xb: self._solve_pairs(xb, Y), blocks)
        return out.reshape(-1, Y.shape[0])[:N1]

    def _diag_raw(self, X):
        G = self.base.gram(X, X)  # [N, L, L] batched
        inc = incremental_gram(G)
        return goursat.signature_kernel_pde(inc, self.dyadic_order)

    def K(self, X, X2=None):
        Xs = self._scaled(X)
        sym = X2 is None
        Ys = Xs if sym else self._scaled(X2)
        K = self._solve_rows_blocked(Xs, Ys)
        if self.normalization:
            # The true untruncated kernel has k(x,x) = ||S(x)||² >= 1
            # (level-0 term), so diag estimates below 1 are pure
            # finite-difference error (possible at dyadic_order=0 on rough
            # paths, where the FD diag can even go negative). Flooring at 1
            # keeps values and hyper-gradients finite — dividing by
            # max(dx*dy, eps) instead produces 1e15-scale entries and NaN
            # f32 gradients.
            dx = jnp.maximum(self._diag_raw(Xs), 1.0)
            dy = dx if sym else jnp.maximum(self._diag_raw(Ys), 1.0)
            K = K / jnp.sqrt(dx[:, None] * dy[None, :])
        K = self.sigma * K
        if sym and self.psd_floor is not None and self.psd_floor > 0.0:
            K = _psd_project(K, jnp.asarray(self.psd_floor, K.dtype))
        return K

    def K_sym_psd(self, X):
        """Symmetric Gram for the Kuu path, guaranteed PSD.

        ``InducingSequences`` dispatches here when the kernel provides it:
        the finite-difference Gram is only approximately PSD (module
        docstring), and a Cholesky downstream must not depend on the user
        having read it. With the default ``psd_floor=None`` the floor is
        the dtype jitter; an explicit ``psd_floor=0.0`` opts out."""
        K = self.K(X)  # psd_floor > 0 already projected inside K
        if self.psd_floor is None:
            from gpsig.config import default_jitter

            K = _psd_project(K, jnp.asarray(default_jitter(K.dtype),
                                            K.dtype))
        return K

    def Kdiag(self, X):
        Xs = self._scaled(X)
        if self.normalization:
            return self.sigma * jnp.ones(Xs.shape[0], Xs.dtype)
        return self.sigma * self._diag_raw(Xs)

    def feature(self, X, num_levels):
        """Ψ(X): rescaled truncated-signature coordinates of this kernel's
        Mercer expansion — the VOSF ``Kuf`` under the untruncated prior.

        Reference parity: the SigGPDE VOSF inducing family (reference VOSF
        class, SURVEY.md §2.2 row 3): ``Kuf[I, x]`` = rescaled I-th
        signature coefficient of x, ``Kuu = I``, ``Knn`` = the PDE kernel.
        The untruncated kernel solves to k(x, y) = σ·Σ_I S_I(x)S_I(y) over
        ALL words I (level 0 included; verified against the expansion in
        ``test_pde_converges_to_truncated_signature_kernel``), so

            φ_I(x) = √σ · S_I(x)                       (normalization=False)
            φ_I(x) = √σ · S_I(x) / ‖S(x)‖              (normalization=True)

        is an exact feature expansion of ``K``/``Kdiag`` and any truncated
        prefix of it gives inter-domain features with ``Kuu = I`` exactly
        (u_I = w_I in f = Σ_I w_I φ_I, w ~ N(0, I)). The truncation gap
        ``Knn − Σ_{|I| ≤ num_levels} φ_I²`` is structurally ≥ 0 (it is the
        mass of the dropped words) but *finite-difference approximate* here
        — every marginal conditional path floors it
        (``gauss.floor_marginal_variance``).

        ‖S(x)‖² is the untruncated diag, estimated by the same FD solve
        (and the same ≥ 1 floor) as ``K``'s normalization, so Ψ is exactly
        consistent with the kernel object's own normalized Gram.

        Only the linear base lifts to explicitly-computable signature
        coordinates (a non-linear base kernel is the signature of an
        implicit RKHS-lifted path); others raise.
        """
        if not isinstance(self.base, sk.LinearBase):
            raise NotImplementedError(
                "VOSF features under the untruncated prior require the "
                "linear base kernel (explicit signature coordinates exist "
                f"only for the identity lift); got {type(self.base).__name__}"
            )
        from gpsig.ops import explicit as ex

        Xs = self._scaled(X)
        levels = ex.truncated_signature(Xs, num_levels)
        N = Xs.shape[0]
        cols = [jnp.ones((N, 1), Xs.dtype)] + [
            lv.reshape(N, -1) for lv in levels
        ]
        F = jnp.sqrt(self.sigma) * jnp.concatenate(cols, axis=-1)
        if self.normalization:
            norm = jnp.sqrt(jnp.maximum(self._diag_raw(Xs), 1.0))
            F = F / norm[:, None]
        return F
