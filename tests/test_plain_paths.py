"""The plain XLA paths against the brute-force oracles, over the parameter
grids the configurations outside the fused kernel use: every base kind ×
order × difference for the Gram, increments × levels for the
tensor-vs-sequence covariance, and Goursat shapes × dyadic order. Gradients
are checked by finite differences at float64; ``check_grads``'s central
differences (step 1e-4 at f64) carry an O(step²) truncation error, hence
the 1e-5 tolerance on those checks.
"""

import numpy as np
import pytest

import jax.numpy as jnp
from jax.test_util import check_grads

from gpsig.kernels.signature import (
    SignatureCosine,
    SignatureLinear,
    SignaturePoly,
    SignatureRBF,
)
from gpsig.ops import goursat
from gpsig.ops.signature import tensor_factor_count
from oracles import (
    explicit_sig_kernel_levels,
    goursat_solve_naive,
    sig_kernel_levels,
    sig_tens_vs_seq_levels,
)

_OFFSET = 0.7


def _paths(rng, N, L, d, scale=0.4):
    return (scale * rng.standard_normal((N, L, d))).cumsum(axis=1)


def _kernel(kind, nl, **kw):
    kw = {"engine": "xla", "normalization": False, "lengthscales": 1.0,
          **kw}
    if kind == "rbf":
        return SignatureRBF(2, nl, **kw)
    if kind == "linear":
        return SignatureLinear(2, nl, **kw)
    if kind == "poly2":
        return SignaturePoly(2, nl, offset=_OFFSET, degree=2, **kw)
    return SignatureCosine(2, nl, **kw)


def _base_gram(kind, a, b):
    """numpy base Gram k(a_i, b_j): [n, d] × [m, d] → [n, m]."""
    if kind == "linear":
        return a @ b.T
    if kind == "poly2":
        return (a @ b.T + _OFFSET) ** 2
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    if kind == "rbf":
        return np.exp(-0.5 * d2)
    return np.cos(np.sqrt(d2))


KINDS = ["rbf", "linear", "poly2", "cosine"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("difference", [True, False])
def test_signature_gram_matches_oracle(kind, order, difference):
    rng = np.random.default_rng(0)
    nl = 3
    X, Y = _paths(rng, 2, 5, 2), _paths(rng, 2, 4, 2)
    kern = _kernel(kind, nl, order=order, difference=difference)
    got = np.asarray(kern.K(jnp.asarray(X), jnp.asarray(Y),
                            return_levels=True))
    for i in range(2):
        for j in range(2):
            G = _base_gram(kind, X[i], Y[j])
            M = np.diff(np.diff(G, axis=0), axis=1) if difference else G
            want = sig_kernel_levels(M, nl, order)
            np.testing.assert_allclose(got[:, i, j], want, rtol=1e-9,
                                       atol=1e-12)


@pytest.mark.parametrize("order", [3, 5])
def test_exact_order_matches_explicit_signature(order):
    """order >= num_levels is the exact signature of the piecewise-linear
    path: with the linear base it equals ⟨S(x), S(y)⟩ level by level."""
    rng = np.random.default_rng(1)
    nl = 3
    X, Y = _paths(rng, 2, 6, 2), _paths(rng, 3, 6, 2)
    kern = _kernel("linear", nl, order=order)
    got = np.asarray(kern.K(jnp.asarray(X), jnp.asarray(Y),
                            return_levels=True))
    for i in range(2):
        for j in range(3):
            want = explicit_sig_kernel_levels(X[i], Y[j], nl)
            np.testing.assert_allclose(got[:, i, j], want, rtol=1e-9,
                                       atol=1e-12)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("order", [1, 2])
def test_signature_gram_grad_finite_differences(kind, order):
    rng = np.random.default_rng(2)
    X = jnp.asarray(_paths(rng, 2, 5, 2))
    Y = jnp.asarray(_paths(rng, 3, 5, 2))
    kern = _kernel(kind, 3, order=order, normalization=True)
    w = jnp.asarray(rng.standard_normal((2, 3)))
    check_grads(lambda x, y: jnp.sum(w * kern.K(x, y)), (X, Y), order=1,
                modes=["rev"], atol=1e-5, rtol=1e-5)


def _tens_oracle(kind, Z, x, nl, order, increments, difference):
    """Naive ⟨z^(m), S_m(x)⟩ for one tensor and one sequence."""
    if increments:
        U = _base_gram(kind, Z[:, 1], x) - _base_gram(kind, Z[:, 0], x)
    else:
        U = _base_gram(kind, Z, x)
    if difference:
        U = np.diff(U, axis=1)
    levels, off = [], 0
    for m in range(1, nl + 1):
        levels.append(U[off:off + m])
        off += m
    return sig_tens_vs_seq_levels(levels, order)


def _tens_inputs(rng, nl, increments, T=3, N=2, L=6):
    F = tensor_factor_count(nl)
    shape = (T, F, 2, 2) if increments else (T, F, 2)
    Z = 0.5 * rng.standard_normal(shape)
    return Z, _paths(rng, N, L, 2)


def _check_tens(kind, nl, order, increments, difference, seed):
    rng = np.random.default_rng(seed)
    Z, X = _tens_inputs(rng, nl, increments)
    kern = _kernel(kind, nl, order=order, difference=difference)
    got = np.asarray(kern.K_tens_vs_seq(jnp.asarray(Z), jnp.asarray(X),
                                        increments=increments,
                                        return_levels=True))
    for t in range(Z.shape[0]):
        for n in range(X.shape[0]):
            want = _tens_oracle(kind, Z[t], X[n], nl, order, increments,
                                difference)
            np.testing.assert_allclose(got[:, t, n], want[1:], rtol=1e-9,
                                       atol=1e-12)


@pytest.mark.parametrize("kind", ["rbf", "linear"])
@pytest.mark.parametrize("increments", [True, False])
@pytest.mark.parametrize("nl", [2, 4, 5])
def test_tens_vs_seq_matches_oracle(kind, increments, nl):
    _check_tens(kind, nl, 1, increments, True, seed=10 + nl)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("difference", [True, False])
def test_tens_vs_seq_general_matches_oracle(kind, order, difference):
    _check_tens(kind, 3, order, False, difference, seed=20 + order)


@pytest.mark.parametrize("kind", ["rbf", "linear"])
@pytest.mark.parametrize("increments", [True, False])
def test_tens_vs_seq_grad_finite_differences(kind, increments):
    rng = np.random.default_rng(30)
    Z, X = _tens_inputs(rng, 3, increments)
    kern = _kernel(kind, 3, normalization=True)
    w = jnp.asarray(rng.standard_normal((Z.shape[0], X.shape[0])))
    check_grads(
        lambda z, x: jnp.sum(w * kern.K_tens_vs_seq(z, x, increments)),
        (jnp.asarray(Z), jnp.asarray(X)), order=1, modes=["rev"],
        atol=1e-5, rtol=1e-5)


def _refine_np(inc, o):
    f = 2**o
    return np.repeat(np.repeat(inc, f, axis=0), f, axis=1) / (f * f)


@pytest.mark.parametrize("shape", [(5, 5), (5, 3), (4, 6), (12, 9)])
@pytest.mark.parametrize("dyadic_order", [0, 1, 2])
def test_pde_refined_matches_naive(shape, dyadic_order):
    rng = np.random.default_rng(40)
    inc = 0.4 * rng.standard_normal((3,) + shape)
    got = np.asarray(goursat.signature_kernel_pde(jnp.asarray(inc),
                                                  dyadic_order))
    want = [goursat_solve_naive(_refine_np(a, dyadic_order))[-1, -1]
            for a in inc]
    np.testing.assert_allclose(got, want, rtol=1e-10)


@pytest.mark.parametrize("shape", [(5, 3), (4, 6)])
@pytest.mark.parametrize("dyadic_order", [0, 2])
def test_pde_refined_grad_finite_differences(shape, dyadic_order):
    """The adjoint-PDE custom VJP against finite differences at f64."""
    rng = np.random.default_rng(41)
    inc = jnp.asarray(0.4 * rng.standard_normal((2,) + shape))
    gbar = jnp.asarray(rng.standard_normal(2))
    check_grads(
        lambda a: jnp.sum(gbar * goursat.signature_kernel_pde(a,
                                                              dyadic_order)),
        (inc,), order=1, modes=["rev"], atol=1e-5, rtol=1e-5)
