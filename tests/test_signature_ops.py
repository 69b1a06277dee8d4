"""Oracle tests for the truncated signature recursions.

Mirrors the reference's notebook sanity checks (SURVEY.md §4): brute-force
tuple enumeration and explicit Chen signatures as ground truth.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from gpsig.ops import signature as sig
from oracles import (
    explicit_sig_kernel_levels,
    sig_kernel_levels,
    sig_tens_vs_seq_levels,
)


def _rand_M(rng, L1, L2, scale=0.5):
    return scale * rng.standard_normal((L1, L2))


@pytest.mark.parametrize("order", [1, 2, 3, 5])
@pytest.mark.parametrize("num_levels", [1, 2, 3, 4])
def test_signature_kern_vs_bruteforce(order, num_levels):
    rng = np.random.default_rng(0)
    M = _rand_M(rng, 5, 6)
    got = sig.signature_kern(jnp.asarray(M), num_levels, order=order)
    want = sig_kernel_levels(M, num_levels, order=order)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-10, atol=1e-12)


def test_signature_kern_batched_matches_loop():
    rng = np.random.default_rng(1)
    M = 0.3 * rng.standard_normal((2, 3, 4, 5))
    got = sig.signature_kern(jnp.asarray(M), 3, order=2)
    assert got.shape == (4, 2, 3)
    for a in range(2):
        for b in range(3):
            want = sig_kernel_levels(M[a, b], 3, order=2)
            np.testing.assert_allclose(np.asarray(got[:, a, b]), want, rtol=1e-10)


@pytest.mark.parametrize("num_levels", [1, 2, 3, 4])
def test_exact_signature_linear_kernel(num_levels):
    """order >= num_levels with a linear base kernel == explicit Chen signature."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((6, 3)).cumsum(0) * 0.4
    y = rng.standard_normal((5, 3)).cumsum(0) * 0.4
    K = x @ y.T  # step-level linear Gram [Lx, Ly]
    M = np.asarray(sig.incremental_gram(jnp.asarray(K)))
    got = sig.signature_kern(jnp.asarray(M), num_levels, order=num_levels)
    want = explicit_sig_kernel_levels(x, y, num_levels)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-9, atol=1e-12)


def test_order_capped_at_num_levels():
    rng = np.random.default_rng(3)
    M = _rand_M(rng, 4, 4)
    a = sig.signature_kern(jnp.asarray(M), 3, order=3)
    b = sig.signature_kern(jnp.asarray(M), 3, order=7)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12)


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("num_levels", [1, 2, 3, 4])
def test_tens_vs_seq_vs_bruteforce(order, num_levels):
    rng = np.random.default_rng(4)
    L = 6
    U_levels = [0.6 * rng.standard_normal((m, L)) for m in range(1, num_levels + 1)]
    U = np.concatenate(U_levels, axis=0)  # [F, L]
    got = sig.signature_kern_tens_vs_seq(jnp.asarray(U), num_levels, order=order)
    want = sig_tens_vs_seq_levels(U_levels, order=order)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-10, atol=1e-12)


def test_tens_vs_seq_consistency_with_seq_kernel():
    """A rank-1 tensor built from one path's increments reproduces... no —
    simpler invariant: with num_levels=1 the tens-vs-seq kernel is the plain
    sum of factor evaluations, and signature_kern level 1 is sum(M)."""
    rng = np.random.default_rng(5)
    U = rng.standard_normal((1, 7))
    got = sig.signature_kern_tens_vs_seq(jnp.asarray(U), 1, order=1)
    np.testing.assert_allclose(np.asarray(got[1]), U.sum(), rtol=1e-12)


def test_signature_kern_tens_products():
    rng = np.random.default_rng(6)
    nl = 3
    F = sig.tensor_factor_count(nl)
    G = rng.standard_normal((2, 2, F))
    got = np.asarray(sig.signature_kern_tens(jnp.asarray(G), nl))
    assert got.shape == (nl + 1, 2, 2)
    np.testing.assert_allclose(got[0], 1.0)
    np.testing.assert_allclose(got[1], G[..., 0], rtol=1e-12)
    np.testing.assert_allclose(got[2], G[..., 1] * G[..., 2], rtol=1e-12)
    np.testing.assert_allclose(got[3], G[..., 3] * G[..., 4] * G[..., 5], rtol=1e-12)


def test_repeated_last_observation_padding_is_masked():
    """The reference pads ragged sequences by repeating the final observation,
    which zeroes trailing increments and so leaves the recursion invariant
    (SURVEY.md §2.1 preprocessing note — load-bearing trick)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((5, 2)).cumsum(0)
    y = rng.standard_normal((6, 2)).cumsum(0)
    xp = np.concatenate([x, np.repeat(x[-1:], 3, axis=0)], axis=0)
    K1 = jnp.asarray(x @ y.T)
    K2 = jnp.asarray(xp @ y.T)
    a = sig.signature_kern(sig.incremental_gram(K1), 3, order=2)
    b = sig.signature_kern(sig.incremental_gram(K2), 3, order=2)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-10)
