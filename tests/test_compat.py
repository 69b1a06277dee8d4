"""Tests for the GPSig-compatible API surface (gpsig.compat).

The compat layer must (a) expose the reference's module layout and call
conventions (SURVEY.md §2.1: flattened [N, L*d] inputs, ``input_dim``
first, numpy-in/out ``compute_*`` twins, data-holding SVGP with
minibatching, GPflow-style optimizer objects), and (b) agree numerically
with the functional core it wraps.
"""

import numpy as np
import pytest

from gpsig import compat as gpsig
from gpsig.kernels.signature import SignatureRBF as CoreRBF
from gpsig.ops.signature import tensor_factor_count

N, L, D, C, NL = 20, 10, 2, 3, 3


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    X = 0.4 * rng.standard_normal((N, L * D))
    y = rng.integers(0, C, N)
    return X, y


def test_kernel_matches_core_and_is_numpy(data):
    X, _ = data
    kern = gpsig.kernels.SignatureRBF(
        input_dim=L * D, num_features=D, num_levels=NL, lengthscales=0.8
    )
    core = CoreRBF(D, NL, lengthscales=0.8)
    K = kern.compute_K_symm(X)
    assert isinstance(K, np.ndarray)
    np.testing.assert_allclose(K, np.asarray(core.K(X)), rtol=1e-12)
    np.testing.assert_allclose(
        kern.compute_K(X[:5], X[5:9]), np.asarray(core.K(X[:5], X[5:9])),
        rtol=1e-12,
    )
    np.testing.assert_allclose(
        kern.compute_Kdiag(X), np.diag(K), rtol=1e-10, atol=1e-12
    )
    # parameter views are numpy
    assert kern.lengthscales.shape == (D,)
    assert kern.variances.shape == (NL + 1,)


def test_kernel_input_dim_validation(data):
    X, _ = data
    kern = gpsig.kernels.SignatureRBF(input_dim=L * D, num_features=D,
                                      num_levels=NL)
    with pytest.raises(ValueError):
        kern.K(X[:, :-2])
    with pytest.raises(ValueError):
        gpsig.kernels.SignatureRBF(input_dim=21, num_features=2,
                                   num_levels=NL)


def test_tensor_methods_and_inducing_wrapper(data):
    X, _ = data
    rng = np.random.default_rng(1)
    F = tensor_factor_count(NL)
    Z = 0.3 * rng.standard_normal((6, F, 2, D))
    kern = gpsig.kernels.SignatureRBF(input_dim=L * D, num_features=D,
                                      num_levels=NL)
    feat = gpsig.inducing_variables.InducingTensors(Z, NL, increments=True)
    assert len(feat) == 6
    Kuu = np.asarray(feat.Kuu(kern))
    Kuf = np.asarray(feat.Kuf(kern, X))
    assert Kuu.shape == (6, 6) and Kuf.shape == (6, N)
    np.testing.assert_allclose(
        kern.compute_K_tens_vs_seq(Z, X, increments=True),
        np.asarray(
            kern.to_functional().K_tens_vs_seq(Z, X, increments=True)
        ),
        rtol=1e-12,
    )
    # eigenvalues of Kuu (with its default jitter) are positive
    assert np.linalg.eigvalsh(Kuu).min() > 0


def test_low_rank_kernel_approximates_dense(data):
    X, _ = data
    dense = gpsig.kernels.SignatureRBF(input_dim=L * D, num_features=D,
                                       num_levels=NL)
    lowrank = gpsig.kernels.SignatureRBF(
        input_dim=L * D, num_features=D, num_levels=NL, low_rank=True,
        num_components=40,
    )
    Kd = dense.compute_K_symm(X)
    Kl = lowrank.compute_K_symm(X)
    assert Kl.shape == Kd.shape
    # K is exactly the explicit feature map's outer product (approximation
    # *quality* vs rank is covered by tests/test_feature_kernels.py)
    Phi = np.asarray(lowrank.feature(X))
    np.testing.assert_allclose(Phi @ Phi.T, Kl, rtol=1e-8, atol=1e-10)
    assert np.all(np.isfinite(Kl)) and np.linalg.eigvalsh(Kl).min() > -1e-8


def test_svgp_wrapper_trains_and_predicts(data):
    X, y = data
    rng = np.random.default_rng(2)
    F = tensor_factor_count(NL)
    Z = 0.3 * rng.standard_normal((5, F, D))
    kern = gpsig.kernels.SignatureRBF(input_dim=L * D, num_features=D,
                                      num_levels=NL)
    feat = gpsig.inducing_variables.InducingTensors(Z, NL)
    model = gpsig.models.SVGP(
        X, y, kern, gpsig.likelihoods.MultiClass(C), feat=feat,
        num_latent=C, minibatch_size=8,
    )
    e0 = model.compute_log_likelihood_full()
    nat = gpsig.training.NatGradOptimizer(0.2)
    adam = gpsig.training.AdamOptimizer(1e-2)
    for _ in range(10):
        nat.minimize(model, maxiter=1)
        adam.minimize(model, maxiter=1, freeze_variational=True)
    e1 = model.compute_log_likelihood_full()
    assert np.isfinite(e0) and np.isfinite(e1) and e1 > e0
    # the wrapped kernel view tracks the optimized pytree: Adam moved the
    # hyperparameters away from their initial values...
    assert not np.allclose(kern.lengthscales, 1.0)
    # ...and the wrapper reflects exactly the optimized pytree values
    np.testing.assert_allclose(
        kern.lengthscales,
        np.asarray(model.to_functional().kernel.lengthscales),
    )
    m, v = model.predict_y(X[:4])
    assert m.shape == (4, C) and v.shape == (4, C)
    np.testing.assert_allclose(m.sum(1), 1.0, atol=1e-6)
    den = model.predict_density(X[:4], y[:4])
    assert den.shape == (4,) and np.all(np.isfinite(den))
    # minibatch ELBO estimator is finite and uses the data it owns
    assert np.isfinite(model.compute_log_likelihood())


def test_fit_helper_improves_elbo(data):
    X, y = data
    rng = np.random.default_rng(3)
    Z = np.asarray(
        0.3 * rng.standard_normal((4, 5, D)).cumsum(1), np.float64
    )
    kern = gpsig.kernels.SignatureRBF(input_dim=L * D, num_features=D,
                                      num_levels=NL)
    feat = gpsig.inducing_variables.InducingSequences(Z)
    model = gpsig.models.SVGP(
        X, (y == 1).astype(np.float64)[:, None], kern,
        gpsig.likelihoods.Bernoulli(), feat=feat, num_latent=1,
    )
    e0 = model.compute_log_likelihood_full()
    e1 = gpsig.training.fit(model, maxiter=10, learning_rate=1e-2,
                            gamma=0.2)
    assert e1 > e0


def test_pde_kernel_wrapper(data):
    X, _ = data
    from gpsig.kernels.pde import UntruncatedSignatureKernel

    # smooth paths (cumsum) — at dyadic_order=0 the finite-difference diag
    # is only meaningful on smooth inputs (see kernels/pde.py normalization
    # note); the unnormalized kernel is exact parity regardless
    Xs = 0.2 * X.reshape(N, L, D).cumsum(1)[:6].reshape(6, L * D)
    kern = gpsig.kernels.UntruncSignatureKernel(
        input_dim=L * D, num_features=D, dyadic_order=0, normalization=False
    )
    core = UntruncatedSignatureKernel.create(D, dyadic_order=0,
                                             normalization=False)
    K = kern.compute_K_symm(Xs)
    np.testing.assert_allclose(
        K, np.asarray(core.K(Xs.reshape(6, L, D))), rtol=1e-10
    )
    np.testing.assert_allclose(kern.compute_Kdiag(Xs),
                               np.diag(K), rtol=1e-8)


def test_preprocessing_reexports():
    rng = np.random.default_rng(4)
    seqs = [rng.standard_normal((l, D)) for l in (5, 8, 6)]
    seqs_t = gpsig.preprocessing.add_time_to_list(seqs)
    assert seqs_t[0].shape == (5, D + 1)
    tab = gpsig.preprocessing.tabulate_list_of_sequences(seqs_t)
    assert tab.shape == (3, 8, D + 1)
    # repeat-last-observation padding
    np.testing.assert_allclose(tab[0, 5:], np.tile(tab[0, 4], (3, 1)))


def _tiny_svgp(data, seed=7, minibatch=8):
    X, y = data
    rng = np.random.default_rng(seed)
    F = tensor_factor_count(NL)
    Z = 0.3 * rng.standard_normal((4, F, D))
    kern = gpsig.kernels.SignatureRBF(input_dim=L * D, num_features=D,
                                      num_levels=NL)
    feat = gpsig.inducing_variables.InducingTensors(Z, NL)
    return gpsig.models.SVGP(
        X, y, kern, gpsig.likelihoods.MultiClass(C), feat=feat,
        num_latent=C, minibatch_size=minibatch, seed=seed,
    )


def test_natgrad_gamma_is_live(data):
    """Mutating nat.gamma mid-training must take effect (ADVICE round 1:
    gamma was baked in at trace time)."""
    m_a = _tiny_svgp(data, seed=11)
    m_b = _tiny_svgp(data, seed=11)
    nat_a = gpsig.training.NatGradOptimizer(0.3)
    nat_a.minimize(m_a, maxiter=1)
    # annealed optimizer: starts at a dummy gamma, mutated before stepping
    nat_b = gpsig.training.NatGradOptimizer(0.001)
    nat_b.gamma = 0.3
    nat_b.minimize(m_b, maxiter=1)
    np.testing.assert_allclose(
        np.asarray(m_a.to_functional().q_mu),
        np.asarray(m_b.to_functional().q_mu), rtol=1e-10,
    )
    # and a *different* gamma gives a different step
    m_c = _tiny_svgp(data, seed=11)
    nat_c = gpsig.training.NatGradOptimizer(0.3)
    nat_c.gamma = 0.05
    nat_c.minimize(m_c, maxiter=1)
    assert not np.allclose(np.asarray(m_a.to_functional().q_mu),
                           np.asarray(m_c.to_functional().q_mu))


def test_adam_learning_rate_is_live(data):
    """Mutating adam.learning_rate between minimize calls must take effect."""
    m_a = _tiny_svgp(data, seed=12)
    m_b = _tiny_svgp(data, seed=12)
    adam_a = gpsig.training.AdamOptimizer(1e-2)
    adam_a.minimize(m_a, maxiter=2)
    adam_b = gpsig.training.AdamOptimizer(1e-5)
    adam_b.learning_rate = 1e-2
    adam_b.minimize(m_b, maxiter=2)
    np.testing.assert_allclose(
        np.asarray(m_a.to_functional().kernel.lengthscales),
        np.asarray(m_b.to_functional().kernel.lengthscales), rtol=1e-10,
    )


def test_adam_freeze_variational_never_moves_q(data):
    """freeze_variational must hold (q_mu, q_sqrt) exactly fixed even after
    prior *unfrozen* steps on the same optimizer built nonzero Adam moments
    (ADVICE round 1: shared state let stale moments keep moving q)."""
    model = _tiny_svgp(data, seed=13)
    adam = gpsig.training.AdamOptimizer(1e-2)
    adam.minimize(model, maxiter=3, freeze_variational=False)  # builds moments
    q_mu0 = np.asarray(model.to_functional().q_mu).copy()
    q_sqrt0 = np.asarray(model.to_functional().q_sqrt).copy()
    adam.minimize(model, maxiter=3, freeze_variational=True)
    np.testing.assert_array_equal(np.asarray(model.to_functional().q_mu),
                                  q_mu0)
    np.testing.assert_array_equal(np.asarray(model.to_functional().q_sqrt),
                                  q_sqrt0)


def test_adam_state_shared_across_freeze_phases(data):
    """ADVICE round 2: hyperparameter Adam moments must live in ONE state
    shared across freeze_variational phases (the reference alternates
    phases on a single optimizer whose var_list simply excludes the
    variational params), and a frozen phase must leave the variational
    moments bit-identical rather than decaying them toward zero."""
    import optax

    def find_adam(s):
        if isinstance(s, optax.ScaleByAdamState):
            return s
        if isinstance(s, tuple):
            for x in s:
                r = find_adam(x)
                if r is not None:
                    return r
        return None

    model = _tiny_svgp(data, seed=14)
    adam = gpsig.training.AdamOptimizer(1e-2)
    adam.minimize(model, maxiter=2, freeze_variational=False)
    a0 = find_adam(adam._state[model])
    mu_q0 = np.asarray(a0.mu.q_mu).copy()
    nu_q0 = np.asarray(a0.nu.q_mu).copy()
    mu_hyp0 = np.asarray(a0.mu.kernel.raw_lengthscales).copy()
    assert np.any(mu_hyp0 != 0) and np.any(mu_q0 != 0)

    adam.minimize(model, maxiter=3, freeze_variational=True)
    a1 = find_adam(adam._state[model])
    # variational moments pinned bit-identically through the frozen phase
    np.testing.assert_array_equal(np.asarray(a1.mu.q_mu), mu_q0)
    np.testing.assert_array_equal(np.asarray(a1.nu.q_mu), nu_q0)
    # hyper moments advanced in the SAME (shared) state, not a fresh one
    assert not np.array_equal(np.asarray(a1.mu.kernel.raw_lengthscales),
                              mu_hyp0)

    # and the unfrozen phase resumes from those shared hyper moments
    adam.minimize(model, maxiter=1, freeze_variational=False)
    a2 = find_adam(adam._state[model])
    assert not np.array_equal(np.asarray(a2.mu.q_mu), mu_q0)


def test_low_rank_landmarks_deterministic(data):
    """Low-rank Gram values must not depend on which array touches the
    kernel first (ADVICE round 1): X_example pins the landmarks, and a
    fresh low_rank kernel can go straight into a compat SVGP (landmarks
    come from the training data)."""
    X, y = data
    Xtest = X + 0.5  # a 'test set' with a different distribution
    mk = lambda **kw: gpsig.kernels.SignatureRBF(
        input_dim=L * D, num_features=D, num_levels=NL, low_rank=True,
        num_components=16, **kw)
    k1 = mk(X_example=X)
    K_ref = k1.compute_K_symm(X)
    # same X_example → same Grams regardless of call order
    k2 = mk(X_example=X)
    k2.compute_K_symm(Xtest)  # touch test data first
    np.testing.assert_allclose(k2.compute_K_symm(X), K_ref, rtol=1e-12)
    # fresh kernel straight into SVGP: no RuntimeError, landmarks from X_train
    k3 = mk()
    feat = gpsig.inducing_variables.InducingSequences(
        np.asarray(0.3 * np.random.default_rng(5)
                   .standard_normal((4, 5, D)).cumsum(1)))
    model = gpsig.models.SVGP(X, y, k3, gpsig.likelihoods.MultiClass(C),
                              feat=feat, num_latent=C)
    np.testing.assert_allclose(k3.compute_K_symm(X), K_ref, rtol=1e-12)
    assert np.isfinite(model.compute_log_likelihood_full())


def test_compat_predict_uses_cached_posterior():
    """The compat wrapper's predict calls route through a cached
    Posterior (the reference wrapper's prediction-time Kuu-factor caching
    — SURVEY.md §3.2), invalidated when training replaces the functional
    model."""
    import jax.numpy as jnp

    rng = np.random.default_rng(13)
    X = (0.4 * rng.standard_normal((12, 6, 2))).cumsum(1).reshape(12, -1)
    Y = rng.integers(0, 2, (12, 1)).astype(float)
    kern = gpsig.kernels.SignatureRBF(12, num_features=2, num_levels=2,
                                      lengthscales=1.0)
    Z = (0.4 * rng.standard_normal((4, 3, 2))).cumsum(1)
    feat = gpsig.inducing_variables.InducingSequences(Z)
    m = gpsig.models.SVGP(X, Y, kern, gpsig.likelihoods.Bernoulli(),
                          feat=feat, num_latent=1)

    m1, v1 = m.predict_f(X[:5])
    post1 = m._post_cache[1]
    m.predict_y(X[:5])
    assert m._post_cache[1] is post1  # reused, not rebuilt

    # cached predictions agree with the uncached functional model
    np.testing.assert_allclose(
        m1, np.asarray(m.to_functional().predict_f(
            jnp.asarray(X[:5]))[0]), atol=1e-10)

    # a training step invalidates the cache
    opt = gpsig.training.AdamOptimizer(1e-2)
    opt.minimize(m, maxiter=2)
    _ = m.predict_f(X[:5])
    assert m._post_cache[1] is not post1


def test_siggpde_vosf_model_via_compat(data):
    """The fork's headline model through the reference call surface:
    UntruncSignatureKernel + OrthogonalFeatures(kern, num_levels=...)
    (Kuu = I under the untruncated prior) + SVGP(q_diag) + NatGrad/Adam;
    prediction stays finite through the cached-posterior compat path."""
    X, y = data
    kern = gpsig.kernels.UntruncSignatureKernel(
        input_dim=L * D, num_features=D, dyadic_order=1,
        normalization=True)
    feat = gpsig.inducing_variables.OrthogonalFeatures(kern, num_levels=3)
    assert len(feat) == 1 + D + D**2 + D**3
    model = gpsig.models.SVGP(
        X, y, kern, gpsig.likelihoods.MultiClass(C), feat=feat,
        num_latent=C, q_diag=True,
    )
    e0 = model.compute_log_likelihood_full()
    nat = gpsig.training.NatGradOptimizer(0.1)
    adam = gpsig.training.AdamOptimizer(5e-3)
    for _ in range(6):
        nat.minimize(model, maxiter=1)
        adam.minimize(model, maxiter=1, freeze_variational=True)
    e1 = model.compute_log_likelihood_full()
    assert np.isfinite(e0) and np.isfinite(e1) and e1 > e0
    m, v = model.predict_y(X[:4])
    assert m.shape == (4, C) and np.all(np.isfinite(m))
    assert np.all(np.isfinite(v)) and np.all(v >= 0)
