"""NUTS sampler correctness: moments of known targets, adaptation sanity,
sharded multi-chain path."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gpsig.mcmc.sample import run_chains, run_nuts
from gpsig.parallel import mesh as meshlib
from gpsig.parallel.chains import run_chains_sharded


def _corr_gauss_logp():
    cov = np.array([[2.0, 1.2], [1.2, 1.5]])
    prec = jnp.asarray(np.linalg.inv(cov))

    def logp(x):
        return -0.5 * x @ prec @ x

    return logp, cov


def test_nuts_correlated_gaussian_moments():
    logp, cov = _corr_gauss_logp()
    theta, info = run_nuts(
        jax.random.PRNGKey(0), logp, jnp.zeros(2),
        num_warmup=500, num_samples=2000, max_depth=6,
    )
    s = np.asarray(theta)
    assert not np.asarray(info["diverging"]).any()
    assert 0.6 < float(np.mean(np.asarray(info["accept_prob"]))) <= 1.0
    np.testing.assert_allclose(s.mean(0), [0, 0], atol=0.25)
    np.testing.assert_allclose(np.cov(s.T), cov, atol=0.45)


def test_nuts_mass_matrix_adapts_to_scales():
    scales = jnp.asarray([0.1, 10.0])

    def logp(x):
        return -0.5 * jnp.sum((x / scales) ** 2)

    theta, info = run_nuts(
        jax.random.PRNGKey(1), logp, jnp.asarray([0.05, 1.0]),
        num_warmup=800, num_samples=1500, max_depth=8,
    )
    inv_mass = np.asarray(info["inv_mass"])
    # inverse mass ≈ marginal variances: ratio should reflect 1e4 spread
    assert inv_mass[1] / inv_mass[0] > 100
    s = np.asarray(theta)
    np.testing.assert_allclose(
        s.std(0), np.asarray(scales), rtol=0.35
    )


def test_nuts_vmapped_chains():
    logp, cov = _corr_gauss_logp()
    theta, info = run_chains(
        jax.random.PRNGKey(2), logp,
        0.1 * jax.random.normal(jax.random.PRNGKey(3), (4, 2)),
        num_warmup=400, num_samples=800, max_depth=6,
    )
    s = np.asarray(theta).reshape(-1, 2)
    np.testing.assert_allclose(np.cov(s.T), cov, atol=0.4)


def test_nuts_sharded_chains_shared_stepsize():
    logp, cov = _corr_gauss_logp()
    mesh = meshlib.make_mesh(data=8, tile=1)
    C = 16
    theta0 = 0.1 * jax.random.normal(jax.random.PRNGKey(4), (C, 2))
    theta, info = run_chains_sharded(
        jax.random.PRNGKey(5), logp, theta0, mesh,
        num_warmup=300, num_samples=400, max_depth=6,
    )
    assert theta.shape == (C, 400, 2)
    eps = np.asarray(info["step_size"])
    # shared adaptation ⇒ identical step size on every chain
    np.testing.assert_allclose(eps, eps[0], rtol=1e-10)
    s = np.asarray(theta).reshape(-1, 2)
    np.testing.assert_allclose(s.mean(0), [0, 0], atol=0.2)
    np.testing.assert_allclose(np.cov(s.T), cov, atol=0.4)


def test_chunked_dispatch_matches_monolithic():
    """draws_per_dispatch must not change the math: the host-chunked path
    (bounded device dispatches, resumable) threads keys and the absolute
    warmup index exactly like the monolithic scan, so samples, step size,
    mass matrix, and diagnostics agree to float-reassociation noise —
    including a chunk size that splits the warmup mass window and leaves
    ragged final chunks."""
    logp, _ = _corr_gauss_logp()
    mesh = meshlib.make_mesh(data=8, tile=1)
    C = 16
    theta0 = 0.1 * jax.random.normal(jax.random.PRNGKey(6), (C, 2))
    kw = dict(num_warmup=90, num_samples=70, max_depth=5)
    theta_m, info_m = run_chains_sharded(
        jax.random.PRNGKey(7), logp, theta0, mesh, **kw)
    theta_c, info_c = run_chains_sharded(
        jax.random.PRNGKey(7), logp, theta0, mesh,
        draws_per_dispatch=25, **kw)
    np.testing.assert_allclose(np.asarray(theta_c), np.asarray(theta_m),
                               rtol=1e-9, atol=1e-12)
    for k in ("step_size", "inv_mass", "warmup_accept", "accept_prob",
              "num_leaves", "logp"):
        np.testing.assert_allclose(np.asarray(info_c[k]),
                                   np.asarray(info_m[k]),
                                   rtol=1e-9, atol=1e-12, err_msg=k)


def test_checkpoint_resume_matches_uninterrupted(tmp_path):
    """Checkpointing must never perturb the draw stream: (a) a run with
    per-chunk persistence equals the plain chunked run; (b) a run killed
    after every single chunk (fresh sampler object per slice, state only
    on disk — simulating preemption) still reproduces it exactly."""
    from gpsig.parallel.chains import make_chunked_sampler

    logp, _ = _corr_gauss_logp()
    mesh = meshlib.make_mesh(data=8, tile=1)
    theta0 = 0.1 * jax.random.normal(jax.random.PRNGKey(8), (16, 2))
    kw = dict(num_warmup=40, num_samples=30, max_depth=5,
              draws_per_dispatch=13)
    key = jax.random.PRNGKey(9)

    ref_theta, ref_info = make_chunked_sampler(logp, mesh, **kw)(
        key, theta0)

    t2, i2 = make_chunked_sampler(logp, mesh, **kw)(
        key, theta0, checkpoint_dir=str(tmp_path / "a"))
    np.testing.assert_allclose(np.asarray(t2), np.asarray(ref_theta),
                               rtol=1e-12)

    out, slices = None, 0
    while out is None:
        fresh = make_chunked_sampler(logp, mesh, **kw)
        out = fresh(key, theta0, checkpoint_dir=str(tmp_path / "b"),
                    max_chunks=1)
        slices += 1
        assert slices < 30
    assert slices > 3  # actually exercised multiple resumes
    t3, i3 = out
    np.testing.assert_allclose(np.asarray(t3), np.asarray(ref_theta),
                               rtol=1e-12)
    for k in ("step_size", "inv_mass", "warmup_accept", "accept_prob",
              "num_leaves", "logp"):
        np.testing.assert_allclose(np.asarray(i3[k]),
                                   np.asarray(ref_info[k]),
                                   rtol=1e-12, err_msg=k)


def test_chunked_guards_and_empty_sampling(tmp_path):
    """Advisor r3 fixes: (a) max_chunks without checkpoint_dir raises
    instead of silently discarding progress; (b) num_samples=0 returns
    correctly-shaped empty buffers like the monolithic path; (c) resuming
    a checkpoint written under different sampler settings raises."""
    from gpsig.parallel.chains import make_chunked_sampler

    logp, _ = _corr_gauss_logp()
    mesh = meshlib.make_mesh(data=8, tile=1)
    theta0 = 0.1 * jax.random.normal(jax.random.PRNGKey(10), (8, 2))
    key = jax.random.PRNGKey(11)

    s = make_chunked_sampler(logp, mesh, num_warmup=10, num_samples=5,
                             max_depth=4, draws_per_dispatch=4)
    with pytest.raises(ValueError, match="max_chunks"):
        s(key, theta0, max_chunks=1)

    s0 = make_chunked_sampler(logp, mesh, num_warmup=8, num_samples=0,
                              max_depth=4, draws_per_dispatch=4)
    theta, info = s0(key, theta0)
    assert theta.shape == (8, 0, 2)
    assert info["accept_prob"].shape == (8, 0)
    assert info["warmup_accept"].shape == (8, 8)

    cdir = str(tmp_path / "cfg")
    out = s(key, theta0, checkpoint_dir=cdir, max_chunks=1)
    assert out is None  # unfinished slice persisted
    other = make_chunked_sampler(logp, mesh, num_warmup=20, num_samples=5,
                                 max_depth=4, draws_per_dispatch=4)
    with pytest.raises(ValueError, match="different sampler config"):
        other(key, theta0, checkpoint_dir=cdir)


def test_chain_blocks_grouping_invariance():
    """chain_blocks only changes which chains share a vmap block's
    while-loop synchronization (and, with shared step size, the pooling
    set) — for independent chains (shared_step_size=False) any grouping
    must be bit-identical to the single-block run."""
    from gpsig.parallel.chains import make_chunked_sampler

    logp, _ = _corr_gauss_logp()
    mesh = meshlib.make_mesh(devices=jax.devices()[:1])
    theta0 = 0.1 * jax.random.normal(jax.random.PRNGKey(14), (8, 2))
    key = jax.random.PRNGKey(15)
    kw = dict(num_warmup=30, num_samples=20, max_depth=5,
              draws_per_dispatch=12, shared_step_size=False)
    ref_t, ref_i = make_chunked_sampler(logp, mesh, **kw)(key, theta0)
    for g in (2, 4):
        t, i = make_chunked_sampler(logp, mesh, chain_blocks=g, **kw)(
            key, theta0)
        np.testing.assert_array_equal(np.asarray(t), np.asarray(ref_t))
        for k in ("step_size", "inv_mass", "accept_prob", "num_leaves"):
            np.testing.assert_array_equal(
                np.asarray(i[k]), np.asarray(ref_i[k]), err_msg=k)


def test_chain_blocks_shared_stepsize_and_routing():
    """With shared step size, chain_blocks pools dual averaging within
    (block x mesh-axis): the run stays finite/sane, and run_chains_sharded
    routes chain_blocks>1 through the chunked sampler on CPU (where the
    default is otherwise monolithic). Also guards the divisibility check."""
    from gpsig.parallel.chains import make_chunked_sampler

    logp, cov = _corr_gauss_logp()
    mesh = meshlib.make_mesh(data=8, tile=1)
    C = 32
    theta0 = 0.1 * jax.random.normal(jax.random.PRNGKey(16), (C, 2))
    theta, info = run_chains_sharded(
        jax.random.PRNGKey(17), logp, theta0, mesh, num_warmup=150,
        num_samples=150, max_depth=6, chain_blocks=2)
    s = np.asarray(theta).reshape(-1, 2)
    assert np.all(np.isfinite(s))
    emp = np.cov(s.T)
    np.testing.assert_allclose(emp, cov, atol=0.45)
    assert info["accept_prob"].shape == (C, 150)

    with pytest.raises(ValueError, match="chain_blocks"):
        make_chunked_sampler(logp, mesh, num_warmup=4, num_samples=4,
                             draws_per_dispatch=4, chain_blocks=3)(
            jax.random.PRNGKey(0), theta0)


def test_on_chunk_progress_callback():
    """The chunked sampler reports host-side progress after every
    materialized chunk — the timing/monitoring hook for long runs where a
    chunk is the dispatch unit."""
    from gpsig.parallel.chains import make_chunked_sampler

    logp, _ = _corr_gauss_logp()
    mesh = meshlib.make_mesh(data=8, tile=1)
    theta0 = 0.1 * jax.random.normal(jax.random.PRNGKey(12), (8, 2))
    s = make_chunked_sampler(logp, mesh, num_warmup=10, num_samples=5,
                             max_depth=4, draws_per_dispatch=4)
    events = []
    s(jax.random.PRNGKey(13), theta0,
      on_chunk=lambda ph, pos, tot: events.append((ph, pos, tot)))
    assert events == [("warmup", 4, 10), ("warmup", 8, 10),
                      ("warmup", 10, 10), ("sampling", 4, 5),
                      ("sampling", 5, 5)]


def test_nuts_logp_through_fused_engines():
    """The fused Triton Gram kernel composes with the NUTS leapfrog —
    engine='pallas' (interpreted on CPU) logp + grad match the XLA engine
    under vmap, and a short sharded NUTS run executes with the fused
    kernel inside the tree-doubling while_loop."""
    import jax.numpy as jnp

    from gpsig import params as pr
    from gpsig.kernels.signature import SignatureRBF
    from gpsig.models.gpr import GPR

    rng = np.random.default_rng(5)
    N, L, d, nl = 6, 8, 2, 2
    X = jnp.asarray((0.4 * rng.standard_normal((N, L, d))).cumsum(1))
    y = jnp.asarray(rng.standard_normal((N, 1)))

    def make_logp(engine):
        def logp(theta):
            ell = jnp.exp(theta[:d])
            var = jnp.exp(theta[d : d + nl + 1])
            noise = jnp.exp(theta[-1])
            kern = SignatureRBF(d, nl, lengthscales=1.0, order=1,
                                normalization=True, engine=engine)
            kern = kern.replace(
                raw_lengthscales=pr.inv_positive(ell),
                raw_variances=pr.inv_positive(var),
            )
            m = GPR.create(kern, noise_variance=noise)
            return m.log_marginal_likelihood(X, y) - 0.125 * jnp.sum(
                theta**2)
        return logp

    dim = d + nl + 2
    thetas = 0.2 * jax.random.normal(jax.random.PRNGKey(2), (4, dim))
    lx = jax.vmap(make_logp("xla"))(thetas)
    lp = jax.vmap(make_logp("pallas"))(thetas)
    np.testing.assert_allclose(np.asarray(lp), np.asarray(lx),
                               rtol=1e-6)
    gx = jax.vmap(jax.grad(make_logp("xla")))(thetas)
    gp = jax.vmap(jax.grad(make_logp("pallas")))(thetas)
    # the fused kernel and the XLA recompute differ in summation order;
    # the GPR solve amplifies that into the hyper-gradients
    np.testing.assert_allclose(np.asarray(gp), np.asarray(gx),
                               rtol=1e-3, atol=1e-6)

    # fused kernels inside the NUTS while_loop, vmapped chains, sharded
    mesh = meshlib.make_mesh(data=8, tile=1)
    theta0 = 0.1 * jax.random.normal(jax.random.PRNGKey(3), (8, dim))
    samples, info = run_chains_sharded(
        jax.random.PRNGKey(4), make_logp("pallas"), theta0, mesh,
        num_warmup=5, num_samples=5, max_depth=3)
    assert np.all(np.isfinite(np.asarray(samples)))
    assert samples.shape == (8, 5, dim)


def test_legacy_checkpoint_without_chain_blocks_resumes(tmp_path):
    """Advisor r4: checkpoints written before the chain_blocks config key
    existed must resume under the (bit-identical) chain_blocks=1 default
    instead of being rejected by the strict config comparison."""
    import os

    from gpsig.parallel.chains import make_chunked_sampler
    from gpsig.utils.checkpoint import (
        restore_checkpoint,
        save_checkpoint,
    )

    logp, _ = _corr_gauss_logp()
    mesh = meshlib.make_mesh(data=8, tile=1)
    theta0 = 0.1 * jax.random.normal(jax.random.PRNGKey(12), (8, 2))
    key = jax.random.PRNGKey(13)
    kw = dict(num_warmup=12, num_samples=8, max_depth=4,
              draws_per_dispatch=5)

    ref_theta, _ = make_chunked_sampler(logp, mesh, **kw)(key, theta0)

    cdir = str(tmp_path / "legacy")
    out = make_chunked_sampler(logp, mesh, **kw)(
        key, theta0, checkpoint_dir=cdir, max_chunks=1)
    assert out is None
    # strip the chain_blocks key in place — a pre-r4 checkpoint
    (step_dir,) = [d for d in os.listdir(cdir) if d.startswith("chunk_")]
    path = os.path.join(cdir, step_dir)
    tree = restore_checkpoint(path, None)
    assert "chain_blocks" in tree["config"]
    del tree["config"]["chain_blocks"]
    import shutil

    shutil.rmtree(path)
    save_checkpoint(path, tree)

    out = None
    while out is None:
        out = make_chunked_sampler(logp, mesh, **kw)(
            key, theta0, checkpoint_dir=cdir, max_chunks=2)
    t, _ = out
    np.testing.assert_allclose(np.asarray(t), np.asarray(ref_theta),
                               rtol=1e-12)


def test_split_rhat_detects_mixing_and_failure():
    """split_rhat ≈ 1 for iid well-mixed chains; >> 1 when chains sit at
    different locations (a failure ESS alone can miss when within-chain
    autocorrelation is low)."""
    from gpsig.utils.metrics import split_rhat

    rng = np.random.default_rng(0)
    good = rng.standard_normal((8, 400, 3))
    r = split_rhat(good)
    assert r.shape == (3,)
    assert np.all(r < 1.01), r
    bad = good + 3.0 * rng.standard_normal((8, 1, 3))  # chain offsets
    rb = split_rhat(bad)
    assert np.all(rb > 1.2), rb
    # trending chains (first half != second half) also flagged
    trend = good + np.linspace(0, 2, 400)[None, :, None]
    rt = split_rhat(trend)
    assert np.all(rt > 1.05), rt
