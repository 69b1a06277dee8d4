"""Kernel-layer tests: SignatureKernel vs numpy composition of oracles."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gpsig.kernels.signature import (
    SignatureLinear,
    SignaturePoly,
    SignatureRBF,
)
from oracles import explicit_signature, sig_kernel_levels


def _paths(rng, N, L, d, scale=0.4):
    return (scale * rng.standard_normal((N, L, d))).cumsum(axis=1)


def _rbf_gram(a, b, ell):
    a = a / ell
    b = b / ell
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return np.exp(-0.5 * d2)


def _oracle_K(X, Y, ell, num_levels, order, variances, sigma, normalization):
    def levels_pair(x, y):
        G = _rbf_gram(x, y, ell)
        M = np.diff(np.diff(G, axis=0), axis=1)
        return sig_kernel_levels(M, num_levels, order)

    N1, N2 = X.shape[0], Y.shape[0]
    K = np.zeros((N1, N2))
    for i in range(N1):
        dx = levels_pair(X[i], X[i])
        for j in range(N2):
            lv = levels_pair(X[i], Y[j])
            if normalization:
                dy = levels_pair(Y[j], Y[j])
                denom = np.sqrt(np.maximum(dx * dy, 1e-30))
                lv = lv / denom
                lv[0] = 1.0
            K[i, j] = sigma * np.sum(variances * lv)
    return K


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("normalization", [False, True])
def test_K_rbf_vs_oracle(order, normalization):
    rng = np.random.default_rng(0)
    X = _paths(rng, 3, 5, 2)
    Y = _paths(rng, 2, 4, 2)
    nl = 3
    ell = np.array([0.8, 1.3])
    variances = np.array([0.9, 1.1, 0.7, 1.3])
    sigma = 1.7
    kern = SignatureRBF(
        2, nl, lengthscales=ell, order=order, normalization=normalization,
        variances=variances, sigma=sigma,
    )
    got = np.asarray(kern.K(jnp.asarray(X), jnp.asarray(Y)))
    want = _oracle_K(X, Y, ell, nl, order, variances, sigma, normalization)
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)


def test_K_symmetric_psd_and_diag():
    rng = np.random.default_rng(1)
    X = _paths(rng, 6, 7, 3)
    kern = SignatureRBF(3, 4, lengthscales=1.0, order=2, normalization=True)
    K = np.asarray(kern.K(jnp.asarray(X)))
    np.testing.assert_allclose(K, K.T, rtol=1e-10)
    w = np.linalg.eigvalsh(K)
    assert w.min() > -1e-8
    d = np.asarray(kern.Kdiag(jnp.asarray(X)))
    np.testing.assert_allclose(d, np.diag(K), rtol=1e-8)


def test_normalized_diag_is_constant():
    rng = np.random.default_rng(2)
    X = _paths(rng, 5, 6, 2)
    kern = SignatureRBF(2, 3, lengthscales=1.0, normalization=True)
    d = np.asarray(kern.Kdiag(jnp.asarray(X)))
    total = float(kern.sigma * kern.variances.sum())
    np.testing.assert_allclose(d, total, rtol=1e-9)


def test_flattened_input_equivalence():
    rng = np.random.default_rng(3)
    X = _paths(rng, 4, 5, 3)
    kern = SignatureRBF(3, 3, lengthscales=1.0)
    K1 = kern.K(jnp.asarray(X))
    K2 = kern.K(jnp.asarray(X.reshape(4, -1)))
    np.testing.assert_allclose(np.asarray(K1), np.asarray(K2), rtol=1e-12)


def test_K_tens_vs_seq_explicit_signature():
    """Linear base, order = num_levels, no normalization: ⟨z, S(x)⟩ must
    equal the explicit Chen-signature contraction."""
    rng = np.random.default_rng(4)
    nl, d = 3, 2
    X = _paths(rng, 2, 6, d)
    F = nl * (nl + 1) // 2
    Z = rng.standard_normal((2, F, d)) * 0.7
    kern = SignatureLinear(
        d, nl, lengthscales=None, order=nl, normalization=False
    )
    got = np.asarray(kern.K_tens_vs_seq(jnp.asarray(Z), jnp.asarray(X)))
    want = np.zeros((2, 2))
    for n in range(2):
        sigs = explicit_signature(X[n], nl)
        for t in range(2):
            val = 0.0
            off = 0
            for m in range(1, nl + 1):
                s = sigs[m - 1]
                for a in range(m):
                    s = np.tensordot(Z[t, off + a], s, axes=(0, 0))
                val += float(s)
                off += m
            want[t, n] = val
    np.testing.assert_allclose(got, want, rtol=1e-8)


def test_K_tens_linear_product_formula():
    rng = np.random.default_rng(5)
    nl, d = 3, 2
    F = nl * (nl + 1) // 2
    Z = rng.standard_normal((3, F, d))
    kern = SignatureLinear(d, nl, lengthscales=None, normalization=False)
    got = np.asarray(kern.K_tens(jnp.asarray(Z)))
    want = np.zeros((3, 3))
    for t1 in range(3):
        for t2 in range(3):
            off = 0
            for m in range(1, nl + 1):
                prod = 1.0
                for a in range(m):
                    prod *= Z[t1, off + a] @ Z[t2, off + a]
                want[t1, t2] += prod
                off += m
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_K_tens_increments_matches_manual_double_difference():
    rng = np.random.default_rng(6)
    nl, d = 2, 3
    F = nl * (nl + 1) // 2
    Z = rng.standard_normal((2, F, 2, d)) * 0.5
    kern = SignatureRBF(d, nl, lengthscales=1.0, normalization=False)
    got = np.asarray(kern.K_tens(jnp.asarray(Z), increments=True))

    def rbf(a, b):
        return np.exp(-0.5 * ((a - b) ** 2).sum())

    want = np.zeros((2, 2))
    for t1 in range(2):
        for t2 in range(2):
            off = 0
            for m in range(1, nl + 1):
                prod = 1.0
                for a in range(m):
                    z, w = Z[t1, off + a], Z[t2, off + a]
                    prod *= (
                        rbf(z[1], w[1]) - rbf(z[1], w[0])
                        - rbf(z[0], w[1]) + rbf(z[0], w[0])
                    )
                want[t1, t2] += prod
                off += m
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_lags_shapes_and_grads():
    rng = np.random.default_rng(7)
    X = jnp.asarray(_paths(rng, 3, 8, 2))
    kern = SignatureRBF(2, 2, lengthscales=1.0, num_lags=2)
    K = kern.K(X)
    assert K.shape == (3, 3)
    assert np.all(np.isfinite(np.asarray(K)))

    def loss(k):
        return jnp.sum(k.K(X))

    g = jax.grad(loss)(kern)
    assert np.all(np.isfinite(np.asarray(g.raw_lags)))
    assert np.all(np.isfinite(np.asarray(g.raw_gamma)))
    assert np.all(np.isfinite(np.asarray(g.raw_lengthscales)))


def test_poly_kernel_runs():
    rng = np.random.default_rng(8)
    X = jnp.asarray(_paths(rng, 3, 5, 2))
    kern = SignaturePoly(2, 2, lengthscales=1.0, offset=1.0, degree=2)
    K = np.asarray(kern.K(X))
    np.testing.assert_allclose(K, K.T, rtol=1e-10)
    assert np.linalg.eigvalsh(K).min() > -1e-8


# ---------------------------------------------------------------------------
# Engine dispatch parity: engine='pallas' vs engine='xla' through the full
# kernel layer — order >= 2, difference=False, Poly/Cosine bases, lags, and
# gradients. The fused kernel (interpreted on CPU) serves the order-1
# RBF/Linear rows; the others must fall through to the plain path.
# Reference: gpsig/kernels.py::SignatureKernel option surface (SURVEY.md
# §2.1).
# ---------------------------------------------------------------------------

from gpsig.kernels.signature import SignatureCosine  # noqa: E402


def _engine_pair(ctor, d, nl, **kw):
    return (
        ctor(d, nl, engine="xla", **kw),
        ctor(d, nl, engine="pallas", **kw),
    )


@pytest.mark.parametrize(
    "ctor,kw",
    [
        (SignatureRBF, dict(order=2)),
        (SignatureRBF, dict(order=3, normalization=False)),
        (SignatureRBF, dict(order=1, difference=False)),
        (SignatureRBF, dict(order=2, difference=False)),
        (SignatureLinear, dict(order=2)),
        (SignaturePoly, dict(order=2, degree=2, offset=0.7,
                             dtype=jnp.float64)),
        (SignaturePoly, dict(order=1, degree=3, dtype=jnp.float64)),
        (SignatureCosine, dict(order=2)),
    ],
)
def test_general_fused_engine_matches_xla(ctor, kw):
    rng = np.random.default_rng(7)
    X = jnp.asarray(_paths(rng, 5, 7, 2))
    Y = jnp.asarray(_paths(rng, 4, 7, 2))
    kx, kp = _engine_pair(ctor, 2, 4, lengthscales=np.array([0.9, 1.2]),
                          **kw)
    Kx = np.asarray(kx.K(X, Y))
    Kp = np.asarray(kp.K(X, Y))
    np.testing.assert_allclose(Kp, Kx, rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(
        np.asarray(kp.K(X)), np.asarray(kx.K(X)), rtol=2e-5, atol=1e-7)


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("kw", [
    dict(),
    dict(normalization=False),
    dict(difference=False),
])
def test_lags_through_fused_engines(order, kw):
    """num_lags composes with the fused kernel: it sees d·(1+lags)
    channels plus mixing weights (lag augmentation happens upstream) —
    parity incl. lag/gamma gradients."""
    rng = np.random.default_rng(8)
    X = jnp.asarray(_paths(rng, 4, 8, 2))
    Y = jnp.asarray(_paths(rng, 3, 8, 2))
    kx, kp = _engine_pair(SignatureRBF, 2, 3, lengthscales=1.1,
                          num_lags=2, order=order, **kw)
    np.testing.assert_allclose(
        np.asarray(kp.K(X, Y)), np.asarray(kx.K(X, Y)),
        rtol=2e-5, atol=1e-7)

    def loss(kern):
        return jnp.sum(kern.K(X, Y) ** 2)

    gx = jax.grad(loss)(kx)
    gp = jax.grad(loss)(kp)
    for name in ("raw_lags", "raw_gamma", "raw_lengthscales",
                 "raw_variances", "raw_sigma"):
        a, b = getattr(gx, name), getattr(gp, name)
        np.testing.assert_allclose(
            np.asarray(b), np.asarray(a), rtol=5e-4, atol=1e-6,
            err_msg=name)


@pytest.mark.parametrize(
    "ctor,kw",
    [
        (SignatureRBF, dict(order=2)),
        (SignatureRBF, dict(order=2, difference=False)),
        (SignaturePoly, dict(order=2, degree=2, offset=0.6,
                             dtype=jnp.float64)),
        (SignatureCosine, dict(order=3)),
    ],
)
def test_general_fused_engine_grads_match_xla(ctor, kw):
    """Hyperparameter gradients with engine='pallas' (the plain path for
    these configurations, incl. the Poly offset) match the XLA engine."""
    rng = np.random.default_rng(9)
    X = jnp.asarray(_paths(rng, 4, 6, 2))
    Y = jnp.asarray(_paths(rng, 3, 6, 2))
    kx, kp = _engine_pair(ctor, 2, 3, lengthscales=1.0, **kw)

    def loss(kern):
        return jnp.sum(kern.K(X, Y) ** 2)

    gx, gp = jax.grad(loss)(kx), jax.grad(loss)(kp)
    flat_x = jax.tree_util.tree_leaves(gx)
    flat_p = jax.tree_util.tree_leaves(gp)
    for a, b in zip(flat_x, flat_p):
        np.testing.assert_allclose(
            np.asarray(b), np.asarray(a), rtol=5e-4, atol=1e-6)
