"""Truncated signature-kernel dynamic-programming recursions (pure JAX).

This is the JAX re-design of the reference's recursion engine
(reference: ``gpsig/signature_algs.py`` — ``signature_kern``,
``signature_kern_first_order``, ``signature_kern_higher_order``,
``signature_kern_tens_vs_seq``, ``signature_kern_tens``; see SURVEY.md §2.1).
The reference could not be read at build time (empty mount — SURVEY.md
provenance note), so the algorithms are derived from the paper
(Toth & Oberhauser, ICML 2020, arXiv:1906.08215) and verified against
brute-force oracles in ``tests/test_signature_ops.py``.

Math
----
For sequences x = (x_1..x_{Lx}), y = (y_1..y_{Ly}) lifted through a base
kernel k, define the *increment matrix*

    M[i, j] = k(x_{i+1}, y_{j+1}) - k(x_i, y_{j+1}) - k(x_{i+1}, y_j)
              + k(x_i, y_j),                    i < Lx, j < Ly,

i.e. ⟨δφ(x)_i, δφ(y)_j⟩ in the RKHS. The order-p discretised signature of the
piecewise-linear path truncates each step's tensor exponential at degree p,
giving the level-m kernel

    k_m(x, y) = Σ_{i, j} c(i) c(j) Π_{a=1..m} M[i_a, j_a]

where i = (i_1 ≤ ... ≤ i_m) runs over non-decreasing index tuples with run
lengths (multiplicities) ≤ p, and c(i) = Π 1/(r!) over the run lengths r.
p = 1 forbids repeats (strictly increasing tuples — the "first order"
recursion); p ≥ m is the exact signature of the piecewise-linear path.

The DP state for level m is D_{r,s}[i, j]: the sum of all (i-tuple, j-tuple)
contributions whose last entries are exactly (i, j) with current run lengths
(r, s). Transitions append one factor M[i', j']:

    D'_{1,1}[i',j']    = M[i',j'] · Σ_{i<i', j<j'} Σ_{r,s} D_{r,s}[i,j]
    D'_{r+1,1}[i',j']  = M[i',j']/(r+1) · Σ_{j<j'} Σ_s  D_{r,s}[i',j]
    D'_{1,s+1}[i',j']  = M[i',j']/(s+1) · Σ_{i<i'} Σ_r  D_{r,s}[i,j']
    D'_{r+1,s+1}[i,j]  = M[i,j]/((r+1)(s+1)) · D_{r,s}[i,j]

and k_m = Σ_{i,j,r,s} D_{r,s}[i,j].

Device mapping: everything is elementwise multiplies and exclusive cumsums
over the two trailing (sequence) axes — work that XLA fuses; the O(L²) M
tensor comes out of one big matmul in the kernel layer. Shapes keep the two
sequence axes last. A fused Triton kernel for the order-1 Gram lives in
``gpsig/ops/pallas/fused_gram.py``.

All functions take M with shape [..., Lx-1, Ly-1] (arbitrary leading batch
dims) and return per-level kernels stacked on a leading axis:
[num_levels+1, ...] (level 0 is the constant 1 term).
"""

from __future__ import annotations

import jax.numpy as jnp


def ecumsum(x, axis):
    """Exclusive cumulative sum: out[i] = Σ_{i' < i} x[i']."""
    return jnp.cumsum(x, axis=axis) - x


def ecumsum2(x):
    """Exclusive cumsum over both trailing axes: Σ_{i'<i, j'<j} x[i', j']."""
    return ecumsum(ecumsum(x, -1), -2)


def incremental_gram(K):
    """Double-difference a step-level Gram matrix along its two trailing axes.

    K: [..., Lx, Ly] with K[..., i, j] = k(x_i, y_j).
    Returns M: [..., Lx-1, Ly-1] with
    M[i,j] = K[i+1,j+1] - K[i,j+1] - K[i+1,j] + K[i,j].
    """
    d1 = K[..., 1:, :] - K[..., :-1, :]
    return d1[..., :, 1:] - d1[..., :, :-1]


def signature_kern(M, num_levels, order=1, return_levels=True):
    """Per-level signature kernels from an increment matrix.

    Parameters
    ----------
    M : [..., L1, L2] increment matrix (already double-differenced when the
        kernel's ``difference=True``; the raw step Gram otherwise — the
        reference's ``difference`` flag lives in the kernel layer).
    num_levels : signature truncation level (levels 1..num_levels computed).
    order : per-step tensor-exponential truncation p; 1 = cheapest
        approximation, >= num_levels = exact piecewise-linear signature.
    return_levels : if True return [num_levels+1, ...] stacked per-level
        kernels (level 0 = 1); else their sum.
    """
    if order <= 1:
        K = _first_order(M, num_levels)
    else:
        K = _higher_order(M, num_levels, order)
    return K if return_levels else jnp.sum(K, axis=0)


def _first_order(M, num_levels):
    ones = jnp.ones(M.shape[:-2], M.dtype)
    levels = [ones, jnp.sum(M, axis=(-2, -1))]
    A = M
    for _ in range(2, num_levels + 1):
        A = M * ecumsum2(A)
        levels.append(jnp.sum(A, axis=(-2, -1)))
    return jnp.stack(levels, axis=0)


def _higher_order(M, num_levels, order):
    p = min(order, num_levels)
    ones = jnp.ones(M.shape[:-2], M.dtype)
    levels = [ones, jnp.sum(M, axis=(-2, -1))]
    # D[r][s] for r, s in 0..p-1 (run lengths r+1, s+1); None = identically 0.
    D = [[None] * p for _ in range(p)]
    D[0][0] = M
    for m in range(2, num_levels + 1):
        R = min(p, m)
        Dn = [[None] * p for _ in range(p)]
        total = _tree_sum(d for row in D for d in row)
        Dn[0][0] = M * ecumsum2(total)
        for r in range(1, R):
            row = _tree_sum(D[r - 1])
            if row is not None:
                Dn[r][0] = (M / (r + 1)) * ecumsum(row, -1)
            col = _tree_sum(D[s][r - 1] for s in range(p))
            if col is not None:
                Dn[0][r] = (M / (r + 1)) * ecumsum(col, -2)
        for r in range(1, R):
            for s in range(1, R):
                if D[r - 1][s - 1] is not None:
                    Dn[r][s] = (M / ((r + 1) * (s + 1))) * D[r - 1][s - 1]
        D = Dn
        levels.append(
            jnp.sum(_tree_sum(d for row in D for d in row), axis=(-2, -1))
        )
    return jnp.stack(levels, axis=0)


def _tree_sum(items):
    acc = None
    for it in items:
        if it is None:
            continue
        acc = it if acc is None else acc + it
    return acc


# ---------------------------------------------------------------------------
# Tensor-vs-sequence and tensor-vs-tensor recursions (inducing tensors).
# Reference: gpsig/signature_algs.py::signature_kern_tens_vs_seq / _tens.
# ---------------------------------------------------------------------------


def signature_kern_tens_vs_seq(U, num_levels, order=1):
    """⟨z^{(m)}, S_m(x)⟩ for rank-1 tensors z^{(m)} = z_{m,1}⊗…⊗z_{m,m}.

    Parameters
    ----------
    U : [..., F, L] where F = num_levels(num_levels+1)/2 stacks the factor
        rows level-major (level 1's single factor, then level 2's two factors,
        …) and U[..., f, i] = ⟨φ(z_f), δφ(x)_i⟩ — the base-kernel evaluation
        of factor f against the i-th increment of the sequence (single- or
        double-differenced upstream depending on the ``increments`` flag).
        Leading dims are (tensor-batch, sequence-batch) broadcastable.
    num_levels, order : as in :func:`signature_kern`.

    Returns
    -------
    [num_levels+1, ...] per-level ⟨z^{(m)}, S_m(x)⟩; level 0 entry is 1
    (the constant level — sliced off by callers that exclude it).

    DP over the sequence axis only: state E_r^{(a)}[i] = sum over
    non-decreasing index tuples of length a ending at i with run length r
    (run multiplicities ≤ order), of c(i) Π_b U[f_m+b, i_b].
    """
    batch = U.shape[:-2]
    ones = jnp.ones(batch, U.dtype)
    levels = [ones]
    p = max(1, order)
    offset = 0
    for m in range(1, num_levels + 1):
        R = min(p, m)
        # E[r] for r in 0..R-1, each [..., L]
        E = [None] * R
        E[0] = U[..., offset, :]
        for a in range(1, m):
            En = [None] * R
            total = _tree_sum(E)
            Ua = U[..., offset + a, :]
            En[0] = Ua * ecumsum(total, -1)
            for r in range(1, min(R, a + 1)):
                if E[r - 1] is not None:
                    En[r] = (Ua / (r + 1)) * E[r - 1]
            E = En
        levels.append(jnp.sum(_tree_sum(E), axis=-1))
        offset += m
    return jnp.stack(levels, axis=0)


def signature_kern_tens(G, num_levels):
    """⟨z^{(m)}, w^{(m)}⟩ = Π_a ⟨z_{m,a}, w_{m,a}⟩ per level.

    G : [..., F] matched-position factor Grams, G[..., f] = k(z_f, w_f)
        (double-differenced upstream when ``increments=True``), with F the
        level-major triangular stacking as in
        :func:`signature_kern_tens_vs_seq`.

    Returns [num_levels+1, ...]; level 0 entry is 1.
    """
    batch = G.shape[:-1]
    levels = [jnp.ones(batch, G.dtype)]
    offset = 0
    for m in range(1, num_levels + 1):
        levels.append(jnp.prod(G[..., offset : offset + m], axis=-1))
        offset += m
    return jnp.stack(levels, axis=0)


def tensor_factor_count(num_levels):
    """Number of factor vectors per inducing tensor (levels 1..num_levels)."""
    return num_levels * (num_levels + 1) // 2
