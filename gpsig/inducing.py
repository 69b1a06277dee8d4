"""Inducing-variable families for sparse signature GPs.

Reference parity: ``gpsig/inducing_variables.py`` (SURVEY.md §2.1) —
``InducingTensors`` (rank-1 tensor-algebra elements; the paper's novel
inter-domain family), ``InducingSequences`` (short learnable pseudo
sequences), plus the fork's variational orthogonal signature features
(VOSF, SURVEY.md §2.2) where ``Kuu = I``.

The reference wires these into GPflow's ``features.Kuu/Kuf`` multiple
dispatch; here each family is a `gpsig.struct` pytree exposing
``num_inducing``, ``Kuu(kernel)`` and ``Kuf(kernel, X)`` directly — models
call them without a dispatch table (the set of families is closed and the
method signatures are uniform, so dispatch buys nothing under jit).

Inducing tensors
----------------
Each inducing variable is u_z = Σ_{m=1..nl} W_m ⟨z^{(m)}, φ_m(x)⟩ with
z^{(m)} = z_{m,1} ⊗ … ⊗ z_{m,m} a rank-1 element of the level-m tensor
space and φ_m the (optionally normalised) level-m signature feature scaled
by σ²σ_m². Consequently

    Kuu[z, w] = Σ_m σ²σ_m² W_m(z) W_m(w) Π_a k(z_{m,a}, w_{m,a})
    Kuf[z, x] = Σ_m σ²σ_m² W_m(z) ⟨z^{(m)}, S̃_m(x)⟩   (DP recursion)

With ``increments=True`` each factor is an RKHS increment φ(z_b) − φ(z_a)
(factors stored as pairs), matching the reference's ``increments`` flag.
``learn_weights`` enables the per-tensor per-level mixing matrix W
(default: fixed ones).
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp
from gpsig import struct

from gpsig.config import default_jitter
from gpsig.ops import signature as sigops


@struct.dataclass
class InducingTensors:
    raw_Z: jnp.ndarray  # [T, F, d] or [T, F, 2, d] with increments
    raw_W: jnp.ndarray | None  # [T, num_levels] mixing weights (learn_weights)
    num_levels: int = struct.field(pytree_node=False)
    increments: bool = struct.field(pytree_node=False, default=False)

    @classmethod
    def create(cls, Z, num_levels, increments=False, learn_weights=False):
        Z = jnp.asarray(Z)
        F = sigops.tensor_factor_count(num_levels)
        expect = 4 if increments else 3
        if Z.ndim != expect or Z.shape[1] != F:
            raise ValueError(
                f"Z must be [T, {F}, {'2, ' if increments else ''}d]; got "
                f"{Z.shape}"
            )
        W = jnp.ones((Z.shape[0], num_levels), Z.dtype) if learn_weights else None
        return cls(raw_Z=Z, raw_W=W, num_levels=num_levels,
                   increments=increments)

    @property
    def num_inducing(self):
        return self.raw_Z.shape[0]

    def _apply_W(self, levels, side=2):
        """levels: [nl, T, ...]; multiply by W along the tensor axes."""
        if self.raw_W is None:
            return levels
        W = jnp.moveaxis(self.raw_W, -1, 0)  # [nl, T]
        if side == 2:  # [nl, T, T']
            return levels * W[:, :, None] * W[:, None, :]
        return levels * W[:, :, None]  # [nl, T, N]

    def Kuu(self, kernel, jitter=None):
        levels = kernel.K_tens(
            self.raw_Z, increments=self.increments, return_levels=True
        )  # [nl, T, T]
        K = jnp.sum(self._apply_W(levels, side=2), axis=0)
        if jitter is None:
            jitter = default_jitter(K.dtype)
        return K + jitter * jnp.eye(K.shape[-1], dtype=K.dtype)

    def Kuf(self, kernel, X):
        levels = kernel.K_tens_vs_seq(
            self.raw_Z, X, increments=self.increments, return_levels=True
        )  # [nl, T, N]
        return jnp.sum(self._apply_W(levels, side=1), axis=0)


@struct.dataclass
class InducingSequences:
    raw_Z: jnp.ndarray  # [M, Lz, d] learnable pseudo-sequences
    #: jointly PSD-project the [Z; X] training covariance block (see
    #: ``covariances_full``) — the stability treatment for FD-approximate
    #: (PDE) kernels, where separately-guarded Kuu and raw Kuf are
    #: mutually inconsistent at the FD-noise scale
    joint_psd: bool = struct.field(pytree_node=False, default=False)

    @classmethod
    def create(cls, Z, joint_psd=False):
        Z = jnp.asarray(Z)
        if Z.ndim != 3:
            raise ValueError(f"Z must be [M, Lz, d]; got {Z.shape}")
        return cls(raw_Z=Z, joint_psd=joint_psd)

    @property
    def num_inducing(self):
        return self.raw_Z.shape[0]

    def _sym_gram(self, kernel):
        """Symmetric Z-Gram; kernels exposing ``K_sym_psd`` (the PDE
        kernel, whose finite-difference Gram is only approximately PSD)
        get their chol-safe Kuu entry point used automatically."""
        if hasattr(kernel, "K_sym_psd"):
            return kernel.K_sym_psd(self.raw_Z)
        return kernel.K(self.raw_Z)

    def Kuu(self, kernel, jitter=None):
        K = self._sym_gram(kernel)
        if jitter is None:
            jitter = default_jitter(K.dtype)
        return K + jitter * jnp.eye(K.shape[-1], dtype=K.dtype)

    def Kuf(self, kernel, X):
        return kernel.K(self.raw_Z, X)

    def covariances(self, kernel, X, jitter=None):
        """(Kuu, Kuf) in one pass — the Z-side diagonal is computed once
        (the reference's combined-covariance helpers, SURVEY.md §2.1)."""
        if hasattr(kernel, "seq_covariances"):
            Kuu, Kuf = kernel.seq_covariances(self.raw_Z, X)
        else:
            Kuu, Kuf = self._sym_gram(kernel), kernel.K(self.raw_Z, X)
        if jitter is None:
            jitter = default_jitter(Kuu.dtype)
        return (
            Kuu + jitter * jnp.eye(Kuu.shape[-1], dtype=Kuu.dtype),
            Kuf,
        )

    def covariances_full(self, kernel, X, jitter=None):
        """(Kuu, Kuf, Knn) for one training batch, with an optional JOINT
        PSD guarantee (``joint_psd=True``).

        Motivation (round-5 root cause, measured on an FD/Goursat kernel):
        projecting Kuu to PSD *separately* while Kuf keeps raw
        finite-difference values leaves the two mutually inconsistent at
        the FD-noise scale — Kuu directions floored near the jitter
        amplify Kuf noise by 1/√jitter in A = L⁻¹Kuf, which inflated
        ``diag(AᵀA)`` past ``Knn`` on **98% of points** (min −0.45 at σ=1)
        and exploded the whitened natural-gradient step (ELBO −1.6e3 →
        −7.6e4 in one γ=0.05 step). The fix: evaluate the kernel ONCE on
        the concatenated set [Z; X] (the shorter side is padded by
        repeating its last observation — zero increments, a kernel
        invariant), PSD-project the *joint* Gram (straight-through, as in
        ``kernels/pde.py``), and slice Kuu / Kuf / Knn from it. Any PSD
        joint Gram yields ``Knn − diag(AᵀA) ≥ 0`` by the Schur-complement
        identity — measured: 0 negative entries where the separate
        guards left 98%.

        Cost: one (M+B)² FD solve + one (M+B)³ eigh per batch — intended
        for minibatch training (the hot path that explodes); prediction
        continues through the standard ``Kuf``/floored-conditional route.
        Falls back to ``covariances`` + ``Kdiag`` when ``joint_psd`` is
        off or the kernel is exact (no ``K_sym_psd`` marker)."""
        if not (self.joint_psd and hasattr(kernel, "K_sym_psd")):
            Kuu, Kuf = self.covariances(kernel, X, jitter)
            return Kuu, Kuf, kernel.Kdiag(X)
        from gpsig.kernels.pde import _psd_project

        Z = self.raw_Z
        Xs = jnp.asarray(X)
        if Xs.ndim == 2:
            Xs = Xs.reshape(Xs.shape[0], -1, Z.shape[-1])
        M, Lz, d = Z.shape
        N, Lx, _ = Xs.shape
        L = max(Lz, Lx)
        if Lz < L:
            Z = jnp.concatenate(
                [Z, jnp.repeat(Z[:, -1:], L - Lz, axis=1)], axis=1
            )
        if Lx < L:
            Xs = jnp.concatenate(
                [Xs, jnp.repeat(Xs[:, -1:], L - Lx, axis=1)], axis=1
            )
        J = jnp.concatenate([Z, Xs], axis=0)
        # Bound the per-solve pair batch: the wavefront scan keeps every
        # antidiagonal of every pair for its adjoint, ~(2·L·2^o)²·4 B per
        # pair (≈0.3 MB at L=65, dyadic order 1), so a full (M+B)² joint
        # solve grows quadratically in M+B. Blocks of ~2k pairs keep a
        # block's working set near 1 GB of device memory, unless the
        # caller already set a block.
        kern_solve = kernel
        if getattr(kernel, "row_block", 0) == 0:
            nj = J.shape[0]
            kern_solve = kernel.replace(row_block=max(8, 2048 // nj))
        K = kern_solve.K(J)
        if jitter is None:
            jitter = default_jitter(K.dtype)
        Kp = _psd_project(K, jnp.asarray(0.0, K.dtype))
        Kuu = Kp[:M, :M] + jitter * jnp.eye(M, dtype=K.dtype)
        Kuf = Kp[:M, M:]
        Knn = jnp.diagonal(Kp)[M:]
        return Kuu, Kuf, Knn


@struct.dataclass
class InducingVariables:
    """Marker union type (documentation only)."""

    pass


def make_inducing_tensors_from_data(
    key, X, num_tensors, num_levels, num_features, increments=False,
    learn_weights=False, scale=1.0,
):
    """Initialise inducing-tensor factors from data increments (the
    reference initialises Z from randomly drawn sequence segments)."""
    import jax

    X = jnp.asarray(X)
    if X.ndim == 2:
        X = X.reshape(X.shape[0], -1, num_features)
    incs = jnp.diff(X, axis=1)  # [N, L-1, d]
    flat = incs.reshape(-1, incs.shape[-1])
    F = sigops.tensor_factor_count(num_levels)
    n = num_tensors * F * (2 if increments else 1)
    idx = jax.random.choice(key, flat.shape[0], (n,), replace=True)
    Z = flat[idx] * scale
    shape = (
        (num_tensors, F, 2, num_features)
        if increments
        else (num_tensors, F, num_features)
    )
    return InducingTensors.create(
        Z.reshape(shape), num_levels, increments, learn_weights
    )


def make_inducing_sequences_from_data(key, X, num_inducing, length,
                                      num_features):
    """Initialise pseudo-sequences from random data subsequences."""
    import jax

    X = jnp.asarray(X)
    if X.ndim == 2:
        X = X.reshape(X.shape[0], -1, num_features)
    N, L, d = X.shape
    k1, k2 = jax.random.split(jax.random.PRNGKey(0) if key is None else key)
    rows = jax.random.choice(k1, N, (num_inducing,), replace=True)
    starts = jax.random.randint(k2, (num_inducing,), 0, max(1, L - length + 1))
    idx = starts[:, None] + jnp.arange(length)[None, :]
    Z = X[rows[:, None], idx]
    return InducingSequences.create(Z)
