"""Multivariate-Gaussian machinery: KL divergence and sparse conditionals.

Re-implements, natively in JAX, the GPflow 1.5.x layers the reference relies
on (SURVEY.md §2.3): ``gpflow.kullback_leiblers.gauss_kl`` and
``gpflow.conditionals.conditional`` (whitened and unwhitened). These are the
O(M³) / O(M²B) pieces of every SVGP step; they map to chol/triangular-solve +
matmuls (cuSOLVER / cuBLAS on the GPU).

Conventions (match GPflow): ``q_mu`` is [M, C] (C latent GPs), ``q_sqrt`` is
either [C, M, M] lower-triangular or [M, C] (diagonal). ``white=True`` means
u = L v with q(v) = N(q_mu, q_sqrt q_sqrtᵀ) and p(v) = N(0, I).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import scipy as jsp

from gpsig.config import default_jitter, precise_linalg


def _is_diag(q_sqrt):
    return q_sqrt.ndim == 2


def stable_cholesky(K, extra_levels=None):
    """Cholesky with differentiable jitter escalation.

    Inducing-tensor Gram matrices are structurally near-singular (the
    factor tensors correlate strongly), and a *blocked* f32 Cholesky
    accumulates Schur-complement rounding ~M·eps·‖K‖ that can exceed the
    base jitter — at M=500, num_levels=5 the minimum eigenvalue is ~1e-4,
    and whether an f32 factorisation survives depends on the backend's
    blocking and summation order (equilibration does NOT help — the
    ill-conditioning is correlational, not diagonal scaling). This helper
    runs trial
    factorisations under ``stop_gradient`` to pick the smallest extra
    jitter whose Cholesky is finite, then performs ONE differentiable
    Cholesky at that level — so gradients never see a NaN branch and the
    jitter stays minimal when the matrix is healthy.

    K must already include the caller's base jitter. Cost on the healthy
    path: ONE value-only trial at the base level + 1 real factorization;
    the remaining trial levels run inside a ``lax.cond`` and are only
    executed when the first trial produces a non-finite factor, so a
    well-conditioned Kuu never pays more than 2× chol.
    """
    dtype = K.dtype
    if extra_levels is None:
        base = default_jitter(dtype)
        extra_levels = (0.0, 10.0 * base, 100.0 * base, 1000.0 * base)
    M = K.shape[-1]
    eye = jnp.eye(M, dtype=dtype)
    Ks = jax.lax.stop_gradient(K)
    ok0 = jnp.all(
        jnp.isfinite(jnp.linalg.cholesky(Ks + extra_levels[0] * eye))
    )

    def _escalate(_):
        chosen = jnp.asarray(extra_levels[-1], dtype)
        for e in reversed(extra_levels[1:]):
            ok = jnp.all(jnp.isfinite(jnp.linalg.cholesky(Ks + e * eye)))
            chosen = jnp.where(ok, jnp.asarray(e, dtype), chosen)
        return chosen

    chosen = jax.lax.cond(
        ok0, lambda _: jnp.asarray(extra_levels[0], dtype), _escalate, None
    )
    return jnp.linalg.cholesky(K + chosen * eye)


@precise_linalg
def gauss_kl(q_mu, q_sqrt, K=None, K_chol=None):
    """KL[q || p] summed over latents.

    p = N(0, I) if K and K_chol are None (whitened), else N(0, K).
    K may be [M, M] (shared over latents) or [C, M, M].
    """
    M, C = q_mu.shape
    if K is None and K_chol is None:
        # whitened
        mahal = jnp.sum(q_mu**2)
        if _is_diag(q_sqrt):
            s2 = q_sqrt**2
            trace = jnp.sum(s2)
            logdet_q = jnp.sum(jnp.log(s2))
        else:
            trace = jnp.sum(q_sqrt**2)
            diag = jnp.diagonal(q_sqrt, axis1=-2, axis2=-1)
            logdet_q = 2.0 * jnp.sum(jnp.log(jnp.abs(diag)))
        return 0.5 * (mahal + trace - M * C - logdet_q)

    L = K_chol if K_chol is not None else stable_cholesky(K)
    if L.ndim == 2:
        L = jnp.broadcast_to(L, (C,) + L.shape)
    # mahalanobis: q_muᵀ K⁻¹ q_mu
    alpha = jsp.linalg.solve_triangular(
        L, q_mu.T[:, :, None], lower=True
    )  # [C, M, 1]
    mahal = jnp.sum(alpha**2)
    logdet_p = 2.0 * C_logdiag_sum(L)
    if _is_diag(q_sqrt):
        s2 = q_sqrt**2  # [M, C]
        Linv = jsp.linalg.solve_triangular(
            L, jnp.broadcast_to(jnp.eye(M, dtype=L.dtype), L.shape), lower=True
        )  # [C, M, M]
        Kinv_diag = jnp.sum(Linv**2, axis=-2)  # diag of K⁻¹, [C, M]
        trace = jnp.sum(Kinv_diag * s2.T)
        logdet_q = jnp.sum(jnp.log(s2))
    else:
        LiLq = jsp.linalg.solve_triangular(L, q_sqrt, lower=True)  # [C, M, M]
        trace = jnp.sum(LiLq**2)
        diag = jnp.diagonal(q_sqrt, axis1=-2, axis2=-1)
        logdet_q = 2.0 * jnp.sum(jnp.log(jnp.abs(diag)))
    return 0.5 * (mahal + trace - M * C + logdet_p - logdet_q)


def C_logdiag_sum(L):
    d = jnp.diagonal(L, axis1=-2, axis2=-1)
    return jnp.sum(jnp.log(jnp.abs(d)))


def _conditional_var_floor(dtype):
    """Positive floor for marginal conditional variances (see the note in
    ``conditional``): far below any exact-kernel variance (jitter scale),
    high enough that sqrt/log stay finite."""
    return 1e-14 if jnp.dtype(dtype) == jnp.float64 else 1e-8


def floor_marginal_variance(var, scale=None):
    """Clamp marginal predictive variances at a dtype-tiny positive floor.

    Every marginal (``full_cov=False``) conditional path must route through
    this helper — ``gauss.conditional``, ``SVGP._identity_conditional`` and
    ``Posterior.predict_f`` all compute ``Knn − reduce (+ extra)`` by
    subtraction, and two model families make that difference structurally
    fragile:

    * **approximate kernels** — the finite-difference PDE Gram
      (``kernels/pde.py``) is only approximately PSD across (Z, X) jointly,
      so ``Knn − diag(AᵀA)`` can go slightly negative (measured −9.3 at
      dyadic_order=1 on rough paths);
    * **exact-cancellation features** — the VOSF identity path has
      ``Knn ≡ Σ Kuf²`` analytically, so the subtraction is pure rounding
      noise around zero.

    Exact kernels sit orders of magnitude above the floor (jitter scale),
    so the clamp is inert for them (regression-tested).

    ``scale`` (optional): the prior marginals ``Knn`` (or any array whose
    magnitude tracks the kernel amplitude). When given, the floor is
    *relative* — ``base_floor · max|scale|`` — so a kernel with very small
    signal variance (Knn at or below the absolute floor) is not silently
    perturbed, and the floor grows with large-amplitude kernels instead of
    hiding genuine PSD violations under a fixed 1e-8 (advisor r4). A
    ``8·finfo.tiny`` absolute lower bound keeps sqrt/log finite even for
    degenerate all-zero scales.

    ``full_cov=True`` policy: full covariance **matrices** are NOT floored —
    a diagonal clamp cannot restore PSD-ness of a matrix, and the eigen
    projection that could is O(N³) per batch. Full-covariance prediction is
    therefore supported for exact kernels only; approximate-kernel and
    identity-feature users should predict marginals (the likelihood layer
    only consumes marginals anyway).
    """
    floor = jnp.asarray(_conditional_var_floor(var.dtype), var.dtype)
    if scale is not None:
        amp = jnp.max(jnp.abs(scale)).astype(var.dtype)
        tiny = jnp.asarray(8.0 * jnp.finfo(var.dtype).tiny, var.dtype)
        floor = jnp.maximum(floor * amp, tiny)
    return jnp.maximum(var, floor)


@precise_linalg
def conditional(
    Kmn,
    Kmm,
    Knn,
    q_mu,
    q_sqrt,
    white=True,
    full_cov=False,
    Kmm_chol=None,
):
    """Sparse GP predictive q(f) = ∫ p(f | u) q(u) du.

    Kmn: [M, N]; Kmm: [M, M]; Knn: [N] (full_cov=False) or [N, N];
    q_mu [M, C]; q_sqrt [C, M, M] lower-tri or [M, C] diagonal.

    Returns (mean [N, C], var [N, C] or [C, N, N]).
    """
    L = Kmm_chol if Kmm_chol is not None else stable_cholesky(Kmm)
    Aw = jsp.linalg.solve_triangular(L, Kmn, lower=True)  # L⁻¹Kmn, [M, N]
    if white:
        A = Aw
    else:
        A = jsp.linalg.solve_triangular(L.T, Aw, lower=False)  # K⁻¹Kmn
    mean = A.T @ q_mu  # [N, C]

    # posterior-covariance projection: A2ᵀ S A2 with A2 = A (white: L⁻¹Kmn
    # against q(v); unwhitened: K⁻¹Kmn against q(u)).
    if _is_diag(q_sqrt):
        SA = q_sqrt.T[:, :, None] * A[None]  # [C, M, N]
    else:
        SA = jnp.einsum("cmk,kn->cmn", jnp.swapaxes(q_sqrt, -1, -2), A)

    if full_cov:
        red_full = Aw.T @ Aw
        ext_full = jnp.einsum("cmn,cmk->cnk", SA, SA)
        var = Knn[None] - red_full[None] + ext_full  # [C, N, N]
        return mean, var

    reduce_ = jnp.sum(Aw**2, axis=0)  # diag(Knm K⁻¹ Kmn), [N]
    extra = jnp.sum(SA**2, axis=1)  # [C, N]
    var = Knn[None, :] - reduce_[None, :] + extra  # [C, N]
    # Graceful degradation for APPROXIMATE kernels: whitened init (S=I)
    # cancels the A terms exactly, so a joint-PSD violation of an FD Gram
    # surfaces only once q_sqrt moves — a NaN on training step 2.
    # Refinement (dyadic_order) shrinks the violation ~10× per order; the
    # floor (see floor_marginal_variance) is the safety net, not the fix.
    var = floor_marginal_variance(var, scale=Knn)
    return mean, var.T  # [N, C]
