"""Low-rank signature feature maps: Nyström base features + randomised
Hadamard sketching.

Reference parity: ``gpsig/low_rank_calculations.py`` (``Nystrom_map``,
``lr_hadamard_prod(_rand)``) and the low-rank branch of
``gpsig/signature_algs.py`` (SURVEY.md §2.1). The construction:

1. Nyström: landmarks Z ⊂ step space, W = k(Z, Z), φ(x) = k(x, Z) W^{-1/2}
   (pseudo-inverse square root, rank ``num_components``) so
   ⟨φ(x), φ(y)⟩ ≈ k(x, y).
2. Per-level sequence features by the first-order recursion in feature
   space: P₁ = Δφ, P_m[i] = Δφ[i] ⊛ (Σ_{i'<i} P_{m-1}[i']), where ⊛ is the
   column-pair (Khatri-Rao) product. Level-m sequence feature
   F_m = Σ_i P_m[i], giving K ≈ Σ_m σ²σ_m² F_m F_mᵀ.
3. Rank control: the full column-pair product has c² columns; the
   randomised sketch keeps ``rank_bound`` uniformly-sampled pairs scaled by
   √(c²/rank_bound) — an unbiased inner-product estimate. The sampled index
   sets are drawn once and shared by every sequence (they are part of the
   kernel state), so the feature map stays a deterministic function.

All O(L) per level — this is the reference's long-sequence scaling
mechanism (SURVEY.md §5.7) and the cheap path for N > 10k.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gpsig.ops.signature import ecumsum


def nystrom_sqrt_inv(W, num_components, jitter=1e-8):
    """W^{-1/2} restricted to the top ``num_components`` eigenpairs."""
    W = 0.5 * (W + W.T) + jitter * jnp.eye(W.shape[0], dtype=W.dtype)
    vals, vecs = jnp.linalg.eigh(W)
    vals = vals[::-1][:num_components]
    vecs = vecs[:, ::-1][:, :num_components]
    inv_sqrt = jnp.where(vals > 10 * jitter, 1.0 / jnp.sqrt(vals), 0.0)
    return vecs * inv_sqrt[None, :]  # [m, c]


def nystrom_map(points, landmarks, base, num_components, jitter=1e-8):
    """φ(points): [..., d] → [..., num_components]."""
    W = base.gram(landmarks, landmarks)
    P = nystrom_sqrt_inv(W, num_components, jitter)
    shape = points.shape[:-1]
    Kxz = base.gram(points.reshape(-1, points.shape[-1]), landmarks)
    return (Kxz @ P).reshape(shape + (num_components,))


def draw_pair_indices(key, c1, c2, rank_bound):
    """Uniform column-pair sample (i, j) for the sketched product."""
    k1, k2 = jax.random.split(key)
    i = jax.random.randint(k1, (rank_bound,), 0, c1)
    j = jax.random.randint(k2, (rank_bound,), 0, c2)
    return jnp.stack([i, j], axis=0)  # [2, r]


def lr_hadamard_prod(A, B, pair_idx=None):
    """Column-pair product of feature blocks.

    A: [..., c1], B: [..., c2]. Full product → [..., c1*c2]; with
    ``pair_idx`` [2, r] → the sketched [..., r] columns scaled by
    √(c1·c2/r) for unbiased inner products."""
    c1, c2 = A.shape[-1], B.shape[-1]
    if pair_idx is None:
        out = A[..., :, None] * B[..., None, :]
        return out.reshape(A.shape[:-1] + (c1 * c2,))
    r = pair_idx.shape[1]
    scale = jnp.sqrt(jnp.asarray(c1 * c2 / r, A.dtype))
    return A[..., pair_idx[0]] * B[..., pair_idx[1]] * scale


def signature_features(dphi, num_levels, pair_indices=None):
    """Per-level low-rank sequence features from step-feature increments.

    dphi: [N, l, c] (increments of Nyström features along the sequence).
    pair_indices: None (exact Khatri-Rao growth) or list of [2, r] index
    arrays for levels 2..num_levels.

    Returns list of per-level features [N, c_m], m = 1..num_levels.
    """
    feats = [jnp.sum(dphi, axis=-2)]
    P = dphi
    for m in range(2, num_levels + 1):
        idx = None if pair_indices is None else pair_indices[m - 2]
        R = ecumsum(P, axis=-2)  # Σ_{i'<i}
        P = lr_hadamard_prod_axis(dphi, R, idx)
        feats.append(jnp.sum(P, axis=-2))
    return feats


def lr_hadamard_prod_axis(A, B, pair_idx):
    """lr_hadamard_prod with feature axis last, batched over [N, l]."""
    return lr_hadamard_prod(A, B, pair_idx)
