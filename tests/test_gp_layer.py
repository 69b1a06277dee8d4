"""GP-layer tests: KL, conditionals, SVGP↔GPR conjugate identities, natgrad.

Mirrors SURVEY.md §4's plan: ELBO/KL/conditional against closed-form
conjugate cases (exact GPR marginal likelihood as M→N), one-step natural
gradient optimality in the conjugate case.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gpsig import config as cfg
from gpsig import gauss
from gpsig import likelihoods as liks
from gpsig.inducing import InducingSequences, make_inducing_tensors_from_data
from gpsig.kernels.signature import SignatureRBF
from gpsig.models.gpr import GPR
from gpsig.models.svgp import SVGP
from gpsig.training.natgrad import natgrad_step


def _paths(rng, N, L, d, scale=0.5):
    return (scale * rng.standard_normal((N, L, d))).cumsum(axis=1)


@pytest.fixture
def tiny_jitter():
    old = cfg.settings.jitter
    cfg.settings.jitter = 1e-12
    yield
    cfg.settings.jitter = old


def test_gauss_kl_whitened_manual():
    rng = np.random.default_rng(0)
    M, C = 4, 2
    q_mu = rng.standard_normal((M, C))
    A = rng.standard_normal((C, M, M)) * 0.3
    q_sqrt = np.tril(A) + np.eye(M) * 1.0
    got = float(gauss.gauss_kl(jnp.asarray(q_mu), jnp.asarray(q_sqrt)))
    want = 0.0
    for c in range(C):
        S = q_sqrt[c] @ q_sqrt[c].T
        want += 0.5 * (
            q_mu[:, c] @ q_mu[:, c]
            + np.trace(S)
            - M
            - np.linalg.slogdet(S)[1]
        )
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_gauss_kl_unwhitened_manual():
    rng = np.random.default_rng(1)
    M, C = 4, 2
    q_mu = rng.standard_normal((M, C))
    q_sqrt = np.tril(rng.standard_normal((C, M, M)) * 0.2) + np.eye(M)
    B = rng.standard_normal((M, M))
    K = B @ B.T + 0.5 * np.eye(M)
    got = float(
        gauss.gauss_kl(jnp.asarray(q_mu), jnp.asarray(q_sqrt), K=jnp.asarray(K))
    )
    Kinv = np.linalg.inv(K)
    want = 0.0
    for c in range(C):
        S = q_sqrt[c] @ q_sqrt[c].T
        want += 0.5 * (
            q_mu[:, c] @ Kinv @ q_mu[:, c]
            + np.trace(Kinv @ S)
            - M
            + np.linalg.slogdet(K)[1]
            - np.linalg.slogdet(S)[1]
        )
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_gauss_kl_diag_matches_full():
    rng = np.random.default_rng(2)
    M, C = 5, 3
    q_mu = rng.standard_normal((M, C))
    s = np.abs(rng.standard_normal((M, C))) + 0.5
    full = np.stack([np.diag(s[:, c]) for c in range(C)])
    a = float(gauss.gauss_kl(jnp.asarray(q_mu), jnp.asarray(s)))
    b = float(gauss.gauss_kl(jnp.asarray(q_mu), jnp.asarray(full)))
    np.testing.assert_allclose(a, b, rtol=1e-10)


def _conjugate_setup(rng, N=8, L=6, d=2, C=1, noise=0.1):
    X = _paths(rng, N, L, d)
    Y = rng.standard_normal((N, C))
    kern = SignatureRBF(d, 3, lengthscales=1.0, order=2, normalization=True)
    return X, Y, kern


def _optimal_whitened_q(K, Y, noise, jitter):
    """Whitened optimum: μ_v = Lᵀ(K+σ²)⁻¹y, S_v = I − Lᵀ(K+σ²)⁻¹L."""
    N = K.shape[0]
    L = np.linalg.cholesky(K + jitter * np.eye(N))
    Ky = K + noise * np.eye(N)
    Kyi = np.linalg.inv(Ky)
    mu_u = K @ Kyi @ Y
    S_u = K - K @ Kyi @ K
    Li = np.linalg.inv(L)
    mu_v = Li @ mu_u
    S_v = Li @ S_u @ Li.T
    return mu_v, S_v


def test_svgp_elbo_equals_gpr_at_optimum(tiny_jitter):
    rng = np.random.default_rng(3)
    X, Y, kern = _conjugate_setup(rng)
    noise = 0.1
    gpr = GPR.create(kern, noise_variance=noise)
    lml = float(gpr.log_marginal_likelihood(jnp.asarray(X), jnp.asarray(Y)))

    feat = InducingSequences.create(jnp.asarray(X))  # Z = X
    K = np.asarray(kern.K(jnp.asarray(X)))
    mu_v, S_v = _optimal_whitened_q(K, Y, noise, cfg.settings.jitter)
    q_sqrt = np.linalg.cholesky(S_v + 1e-14 * np.eye(len(K)))
    model = SVGP.create(kern, liks.Gaussian.create(noise), feat, num_latent=1)
    model = model.replace(
        q_mu=jnp.asarray(mu_v), q_sqrt=jnp.asarray(q_sqrt[None])
    )
    elbo = float(model.elbo(jnp.asarray(X), jnp.asarray(Y)))
    np.testing.assert_allclose(elbo, lml, rtol=1e-6)

    # and the predictive at the optimum matches GPR's
    Xs = _paths(rng, 3, 6, 2)
    m1, v1 = gpr.predict_f(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(Xs))
    m2, v2 = model.predict_f(jnp.asarray(Xs))
    np.testing.assert_allclose(np.asarray(m2), np.asarray(m1), atol=1e-6)
    np.testing.assert_allclose(np.asarray(v2), np.asarray(v1), atol=1e-6)


def test_natgrad_one_step_reaches_conjugate_optimum(tiny_jitter):
    """γ=1 natural-gradient step solves the conjugate (Gaussian) case."""
    rng = np.random.default_rng(4)
    X, Y, kern = _conjugate_setup(rng)
    noise = 0.15
    feat = InducingSequences.create(jnp.asarray(X))
    model = SVGP.create(kern, liks.Gaussian.create(noise), feat, num_latent=1)
    model = natgrad_step(
        model, 1.0, jnp.asarray(X), jnp.asarray(Y), jitter=0.0
    )
    elbo = float(model.elbo(jnp.asarray(X), jnp.asarray(Y)))
    gpr = GPR.create(kern, noise_variance=noise)
    lml = float(gpr.log_marginal_likelihood(jnp.asarray(X), jnp.asarray(Y)))
    np.testing.assert_allclose(elbo, lml, rtol=1e-6)


def test_natgrad_diag_monotone():
    rng = np.random.default_rng(5)
    X, Y, kern = _conjugate_setup(rng)
    feat = InducingSequences.create(jnp.asarray(X[:5]))
    model = SVGP.create(
        kern, liks.Gaussian.create(0.2), feat, num_latent=1, q_diag=True
    )
    e0 = float(model.elbo(jnp.asarray(X), jnp.asarray(Y)))
    m1 = natgrad_step(model, 0.5, jnp.asarray(X), jnp.asarray(Y))
    e1 = float(m1.elbo(jnp.asarray(X), jnp.asarray(Y)))
    m2 = natgrad_step(m1, 0.5, jnp.asarray(X), jnp.asarray(Y))
    e2 = float(m2.elbo(jnp.asarray(X), jnp.asarray(Y)))
    assert e1 > e0
    assert e2 > e1


def test_likelihood_quadrature_sanity():
    rng = np.random.default_rng(6)
    N, C = 6, 3
    Fmu = jnp.asarray(rng.standard_normal((N, C)))
    tiny = jnp.full((N, C), 1e-10)
    y = jnp.asarray(rng.integers(0, C, N))

    sm = liks.Softmax(num_classes=C, num_samples=4000)
    ve = sm.variational_expectations(y, Fmu, tiny, key=jax.random.PRNGKey(0))
    want = jax.nn.log_softmax(Fmu)[jnp.arange(N), y]
    np.testing.assert_allclose(np.asarray(ve), np.asarray(want), atol=2e-2)

    mc = liks.MultiClass(num_classes=C)
    ve2 = np.asarray(mc.variational_expectations(y, Fmu, tiny))
    # at zero variance, P(argmax = y) is 0 or 1
    amax = np.asarray(jnp.argmax(Fmu, axis=1))
    hit = amax == np.asarray(y)
    want2 = np.where(hit, np.log(1 - 1e-3), np.log(1e-3 / (C - 1)))
    np.testing.assert_allclose(ve2, want2, rtol=1e-5)

    p, _ = mc.predict_mean_and_var(Fmu, jnp.ones_like(Fmu))
    np.testing.assert_allclose(np.asarray(p).sum(1), 1.0, rtol=1e-6)

    bern = liks.Bernoulli()
    yb = jnp.asarray(rng.integers(0, 2, (N, 1)).astype(np.float64))
    fb = Fmu[:, :1]
    veb = np.asarray(bern.variational_expectations(yb, fb, tiny[:, :1]))
    from scipy.stats import norm

    wantb = norm.logcdf((2 * np.asarray(yb) - 1) * np.asarray(fb)).sum(-1)
    np.testing.assert_allclose(veb, wantb, atol=1e-6)


def test_svgp_classification_trains():
    """End-to-end: two separable sequence classes, inducing tensors,
    alternating natgrad + Adam (BASELINE config-2 shaped smoke test)."""
    from gpsig.training.loop import fit

    rng = np.random.default_rng(7)
    N, L, d = 20, 8, 2
    X0 = _paths(rng, N // 2, L, d, scale=0.3)
    X1 = _paths(rng, N // 2, L, d, scale=0.3) + np.linspace(
        0, 2.0, L
    ).reshape(1, L, 1)
    X = np.concatenate([X0, X1]).astype(np.float64)
    Y = np.concatenate([np.zeros(N // 2), np.ones(N // 2)]).astype(np.int32)

    kern = SignatureRBF(d, 3, lengthscales=1.0, order=1, normalization=True)
    feat = make_inducing_tensors_from_data(
        jax.random.PRNGKey(0), jnp.asarray(X), num_tensors=8, num_levels=3,
        num_features=d,
    )
    model = SVGP.create(
        kern, liks.MultiClass(num_classes=2), feat, num_latent=2
    )
    e0 = float(model.elbo(jnp.asarray(X), jnp.asarray(Y)))
    model, hist = fit(
        model, jnp.asarray(X), jnp.asarray(Y), num_iters=60,
        learning_rate=5e-3, gamma=0.05,
    )
    e1 = float(model.elbo(jnp.asarray(X), jnp.asarray(Y)))
    assert e1 > e0
    p, _ = model.predict_y(jnp.asarray(X))
    acc = float((np.asarray(p).argmax(1) == Y).mean())
    assert acc >= 0.9


def test_gp_layer_pins_matmul_precision():
    """Regression: a reduced default matmul precision (TF32 on the GPU,
    or an explicit bfloat16 default) also drives the blocked matmuls inside
    cholesky/triangular_solve.
    The GP layer differences nearly-equal quantities through those solves,
    so it must trace with HIGHEST precision regardless of the global
    default (cf. config.precise_linalg)."""
    M, C, B = 6, 2, 4
    q_mu = jnp.zeros((M, C))
    q_sqrt = jnp.broadcast_to(jnp.eye(M), (C, M, M))
    Kmm = jnp.eye(M) + 0.1
    Kmn = jnp.ones((M, B)) * 0.3
    Knn = jnp.ones((B,))

    with jax.default_matmul_precision("bfloat16"):
        jaxpr = str(jax.make_jaxpr(gauss.conditional)(
            Kmn, Kmm, Knn, q_mu, q_sqrt))
        jaxpr_kl = str(jax.make_jaxpr(gauss.gauss_kl)(
            q_mu, q_sqrt, Kmm))
    # conditional has matmuls/einsums — they must be pinned HIGHEST
    assert "Precision.HIGHEST" in jaxpr
    # neither may carry an unpinned (DEFAULT/None-precision) dot
    for rep, name in ((jaxpr, "conditional"), (jaxpr_kl, "gauss_kl")):
        assert "Precision.DEFAULT" not in rep, name
        assert "precision=None" not in rep, name


def test_f32_jitter_keeps_inducing_tensor_kuu_factorisable():
    """Regression: inducing-tensor Grams are structurally rank-deficient
    (most eigenvalues < 1e-6 even in f64 — low-d factors are nearly
    collinear), so GPflow's 1e-6 jitter sits below f32 rounding error and
    an f32 chol(Kuu) can NaN. default_jitter must be dtype-aware."""
    assert cfg.default_jitter(jnp.float32) >= 1e-4
    assert cfg.default_jitter(jnp.float64) == cfg.settings.jitter
    assert cfg.default_jitter() == cfg.settings.jitter

    rng = np.random.default_rng(0)
    X = jnp.asarray(_paths(rng, 40, 20, 2), jnp.float32)
    kern = SignatureRBF(2, 3, lengthscales=1.0, order=1,
                        normalization=True, dtype=jnp.float32)
    feat = make_inducing_tensors_from_data(
        jax.random.PRNGKey(0), X, num_tensors=64, num_levels=3,
        num_features=2, increments=True,
    )
    Kuu = np.asarray(feat.Kuu(kern), np.float64)
    ev = np.linalg.eigvalsh(Kuu)
    assert ev.min() >= 0.5 * cfg.default_jitter(jnp.float32)
    L = np.asarray(jnp.linalg.cholesky(feat.Kuu(kern)))
    assert np.all(np.isfinite(L))


def test_stable_cholesky_rescues_indefinite_matrix():
    """A blocked f32 Cholesky can NaN on matrices LAPACK survives (M=500
    inducing tensors, num_levels=5 puts Kuu's min eig ≈ the base jitter).
    stable_cholesky escalates jitter under stop_gradient and
    must (a) leave healthy matrices untouched, (b) rescue matrices whose
    plain Cholesky is NaN, (c) keep gradients finite either way."""
    from gpsig import gauss

    rng = np.random.default_rng(0)
    A = rng.standard_normal((12, 12))
    healthy = jnp.asarray(A @ A.T + 12 * np.eye(12))
    L0 = gauss.stable_cholesky(healthy)
    np.testing.assert_allclose(
        np.asarray(L0), np.asarray(jnp.linalg.cholesky(healthy)), rtol=1e-12
    )

    # indefinite: min eig −1e-4 → plain chol NaN, escalation must fix it
    Q, _ = np.linalg.qr(rng.standard_normal((12, 12)))
    ev = np.linspace(1.0, 1e-3, 12)
    ev[-1] = -1e-4
    bad = jnp.asarray(Q @ np.diag(ev) @ Q.T)
    assert not np.all(np.isfinite(np.asarray(jnp.linalg.cholesky(bad))))
    Lb = gauss.stable_cholesky(bad)
    assert np.all(np.isfinite(np.asarray(Lb)))
    # the chosen level is the smallest that clears the deficit
    resid = np.asarray(Lb @ Lb.T - bad)
    assert np.abs(np.diag(resid)).max() < 2e-3

    g = jax.grad(lambda K: jnp.sum(gauss.stable_cholesky(K)))(bad)
    assert np.all(np.isfinite(np.asarray(g)))
    g0 = jax.grad(lambda K: jnp.sum(gauss.stable_cholesky(K)))(healthy)
    want = jax.grad(lambda K: jnp.sum(jnp.linalg.cholesky(K)))(healthy)
    np.testing.assert_allclose(np.asarray(g0), np.asarray(want), rtol=1e-10)


def test_natgrad_diag_backoff_keeps_precision_positive():
    """The diagonal natgrad path must back off gamma (per latent) when the
    new precision S^-1 - 2*gamma*g_S would go negative, instead of pinning
    it at the jitter floor (which inflated S by 1e8 and exploded the KL on
    the VOSF q_diag path at step 0)."""
    from gpsig.training.natgrad import gaussian_natgrad_update

    M, C = 4, 2
    mu = jnp.zeros((M, C))
    S = jnp.ones((M, C))
    g_mu = jnp.ones((M, C))
    # latent 0: benign (full step ok); latent 1: aggressive (needs backoff)
    g_S = jnp.stack([jnp.full((M,), -0.5), jnp.full((M,), 50.0)], axis=1)
    mu2, qs = gaussian_natgrad_update(mu, S, g_mu, g_S, gamma=0.3,
                                      diag=True)
    S_new = np.asarray(qs) ** 2
    assert S_new.max() < 10.0, S_new.max()
    assert np.all(S_new > 0)
    # benign latent took the full step: S' = 1/(1 + 2*0.3*0.5) = 1/1.3
    np.testing.assert_allclose(S_new[:, 0], 1.0 / 1.3, rtol=1e-6)
    # hopeless gradient: no scale keeps precision positive -> no-op
    g_S_bad = jnp.full((M, C), 1000.0)
    mu3, qs3 = gaussian_natgrad_update(mu, S, g_mu, g_S_bad, gamma=0.3,
                                       diag=True)
    np.testing.assert_allclose(np.asarray(qs3), 1.0, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(mu3), 0.0, atol=1e-12)


# ---------------------------------------------------------------------------
# Cached posterior (SVGP.posterior) — reference's prediction-time Kuu-factor
# caching (gpsig/models.py wrapper, SURVEY.md §2.1 Models row / §3.2).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("whiten", [True, False])
@pytest.mark.parametrize("q_diag", [False, True])
def test_posterior_matches_predict_f(whiten, q_diag):
    rng = np.random.default_rng(11)
    X, _, kern = _conjugate_setup(rng, N=9, C=2)
    feat = InducingSequences.create(jnp.asarray(X[:5]))
    model = SVGP.create(kern, liks.Gaussian.create(0.1), feat,
                        num_latent=2, whiten=whiten, q_diag=q_diag)
    M = feat.num_inducing
    q_mu = jnp.asarray(rng.standard_normal((M, 2)))
    if q_diag:
        q_sqrt = jnp.asarray(0.3 + rng.random((M, 2)))
    else:
        A = rng.standard_normal((2, M, M)) * 0.2
        q_sqrt = jnp.asarray(
            np.tril(A) + 0.8 * np.eye(M)[None]
        )
    model = model.replace(q_mu=q_mu, q_sqrt=q_sqrt)

    Xs = jnp.asarray(_paths(rng, 4, 6, 2))
    post = model.posterior()
    m1, v1 = model.predict_f(Xs)
    m2, v2 = post.predict_f(Xs)
    np.testing.assert_allclose(np.asarray(m2), np.asarray(m1), atol=1e-9)
    np.testing.assert_allclose(np.asarray(v2), np.asarray(v1), atol=1e-9)

    mf1, vf1 = model.predict_f(Xs, full_cov=True)
    mf2, vf2 = post.predict_f(Xs, full_cov=True)
    np.testing.assert_allclose(np.asarray(mf2), np.asarray(mf1), atol=1e-9)
    np.testing.assert_allclose(np.asarray(vf2), np.asarray(vf1), atol=1e-9)

    # predict_y parity through the likelihood
    ym1, yv1 = model.predict_y(Xs)
    ym2, yv2 = post.predict_y(Xs)
    np.testing.assert_allclose(np.asarray(ym2), np.asarray(ym1), atol=1e-9)
    np.testing.assert_allclose(np.asarray(yv2), np.asarray(yv1), atol=1e-9)


@pytest.mark.parametrize("q_diag", [True, False])
def test_posterior_vosf_identity_fast_path(q_diag):
    """Kuu = I posterior: diagonal-q keeps the O(M) quad (never builds an
    [M, M] matrix); full-q uses I − SSᵀ."""
    from gpsig.kernels.vosf import (
        ExplicitSignatureKernel,
        OrthogonalSignatureFeatures,
    )

    rng = np.random.default_rng(12)
    kern = ExplicitSignatureKernel.create(2, 3, lengthscales=1.0)
    feat = OrthogonalSignatureFeatures.for_kernel(kern)
    M = feat.num_inducing
    model = SVGP.create(kern, liks.Gaussian.create(0.05), feat,
                        num_latent=1, q_diag=q_diag)
    q_mu = jnp.asarray(rng.standard_normal((M, 1)))
    if q_diag:
        q_sqrt = jnp.asarray(0.2 + rng.random((M, 1)))
    else:
        A = 0.1 * rng.standard_normal((1, M, M))
        q_sqrt = jnp.asarray(np.tril(A) + 0.9 * np.eye(M)[None])
    model = model.replace(q_mu=q_mu, q_sqrt=q_sqrt)

    Xs = jnp.asarray(_paths(rng, 5, 6, 2))
    post = model.posterior()
    if q_diag:
        assert post.quad_is_diag and post.quad.shape == (M, 1)
    m1, v1 = model.predict_f(Xs)
    m2, v2 = post.predict_f(Xs)
    np.testing.assert_allclose(np.asarray(m2), np.asarray(m1), atol=1e-9)
    np.testing.assert_allclose(np.asarray(v2), np.asarray(v1), atol=1e-9)
