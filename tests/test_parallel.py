"""Mocked-mesh distributed tests (8 virtual CPU devices — SURVEY.md §4).

Checks that the sharded paths are *numerically identical* to the single
device ones: Gram tiling over (data × tile), data-parallel ELBO/natgrad/Adam
steps with psum'd statistics.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

from gpsig import likelihoods as liks
from gpsig.inducing import make_inducing_tensors_from_data
from gpsig.kernels.signature import SignatureRBF
from gpsig.models.svgp import SVGP
from gpsig.parallel import mesh as meshlib
from gpsig.parallel.train import make_sharded_step_fn, sharded_gram
from gpsig.training.loop import init_state, make_step_fn


def _paths(rng, N, L, d, scale=0.5):
    return (scale * rng.standard_normal((N, L, d))).cumsum(axis=1)


@pytest.fixture(scope="module")
def mesh2d():
    assert len(jax.devices()) == 8, "conftest must fake 8 CPU devices"
    return meshlib.make_mesh(data=4, tile=2)


@pytest.fixture(scope="module")
def mesh_dp():
    return meshlib.make_mesh(data=8, tile=1)


def test_sharded_gram_matches_dense(mesh2d):
    rng = np.random.default_rng(0)
    X = jnp.asarray(_paths(rng, 8, 6, 2))
    Y = jnp.asarray(_paths(rng, 8, 5, 2))
    kern = SignatureRBF(2, 3, lengthscales=1.0, order=2)
    want = np.asarray(kern.K(X, Y))
    got = np.asarray(sharded_gram(kern, mesh2d, X, Y))
    np.testing.assert_allclose(got, want, rtol=1e-10)


def _make_model(rng, X):
    kern = SignatureRBF(2, 2, lengthscales=1.0, order=1)
    feat = make_inducing_tensors_from_data(
        jax.random.PRNGKey(1), X, num_tensors=4, num_levels=2, num_features=2
    )
    return SVGP.create(kern, liks.MultiClass(num_classes=2), feat,
                       num_latent=2)


@pytest.mark.parametrize("use_natgrad", [False, True])
def test_sharded_step_matches_single_device(mesh_dp, use_natgrad):
    rng = np.random.default_rng(1)
    N = 16
    X = jnp.asarray(_paths(rng, N, 6, 2))
    Y = jnp.asarray(rng.integers(0, 2, N))
    model = _make_model(rng, X)
    opt = optax.adam(1e-2)

    ref_step = make_step_fn(opt, num_data=N, gamma=0.1,
                            use_natgrad=use_natgrad)
    ref_state = init_state(model, opt)
    key = jax.random.PRNGKey(0)
    ref_state, ref_elbo = ref_step(ref_state, X, Y, key)
    ref_state, ref_elbo2 = ref_step(ref_state, X, Y, key)

    sh_step = make_sharded_step_fn(opt, num_data=N, mesh=mesh_dp, gamma=0.1,
                                   use_natgrad=use_natgrad)
    st = init_state(model, opt)
    Xs, Ys = meshlib.shard_batch(mesh_dp, X, Y)
    st, elbo = sh_step(st, Xs, Ys, key)
    st, elbo2 = sh_step(st, Xs, Ys, key)

    np.testing.assert_allclose(float(elbo), float(ref_elbo), rtol=1e-8)
    np.testing.assert_allclose(float(elbo2), float(ref_elbo2), rtol=1e-8)
    np.testing.assert_allclose(
        np.asarray(st.model.q_mu), np.asarray(ref_state.model.q_mu),
        atol=1e-10,
    )
    np.testing.assert_allclose(
        np.asarray(st.model.kernel.raw_lengthscales),
        np.asarray(ref_state.model.kernel.raw_lengthscales), atol=1e-10,
    )


def test_goursat_tile_matches_subgrid():
    from gpsig.ops import goursat
    from gpsig.parallel.goursat_sp import goursat_tile

    rng = np.random.default_rng(10)
    inc = jnp.asarray(0.4 * rng.standard_normal((2, 6, 7)))
    full = goursat.goursat_grid(inc)  # [2, 7, 8]
    # tile covering u rows 3..6, cols 2..7
    tile, bottom = goursat_tile(
        inc[:, 2:6, 1:7],
        top=full[:, 2, 2:8],
        left=full[:, 3:7, 1],
        corner=full[:, 2, 1],
    )
    np.testing.assert_allclose(
        np.asarray(tile), np.asarray(full[:, 3:7, 2:8]), rtol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(bottom), np.asarray(full[:, 6, 2:8]), rtol=1e-10
    )


@pytest.mark.parametrize("col_block", [3, 5, 16])
def test_goursat_seq_sharded_matches_serial(mesh_dp, col_block):
    from gpsig.ops import goursat
    from gpsig.parallel.goursat_sp import goursat_corner_seq_sharded

    rng = np.random.default_rng(11)
    inc = jnp.asarray(0.3 * rng.standard_normal((3, 16, 13)))
    got = goursat_corner_seq_sharded(inc, mesh_dp, col_block=col_block)
    want = goursat.goursat_corner(inc)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=1e-9
    )


def test_sharded_gram_pallas_matches_dense(mesh2d):
    """The fused Triton Gram kernel composed with Gram-tile sharding
    (interpreted on the CPU mesh). Per-shard sizes are deliberately not
    multiples of the kernel's program block: 12 rows / 4 data shards = 3,
    10 cols / 2 tile shards = 5 — the padding must be per-shard correct."""
    rng = np.random.default_rng(3)
    X = jnp.asarray(_paths(rng, 12, 6, 2))
    Y = jnp.asarray(_paths(rng, 10, 6, 2))
    kern_p = SignatureRBF(2, 3, lengthscales=1.0, order=1, engine="pallas")
    kern_x = kern_p.replace(engine="xla")
    want = np.asarray(kern_x.K(X, Y))
    got = np.asarray(sharded_gram(kern_p, mesh2d, X, Y))
    # kernel vs XLA path: same math, other summation order
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_sharded_gram_pallas_symmetric(mesh2d):
    rng = np.random.default_rng(4)
    X = jnp.asarray(_paths(rng, 12, 5, 2))
    kern_p = SignatureRBF(2, 2, lengthscales=1.0, order=1, engine="pallas")
    want = np.asarray(kern_p.replace(engine="xla").K(X))
    got = np.asarray(sharded_gram(kern_p, mesh2d, X))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("use_natgrad", [False, True])
def test_sharded_step_pallas_matches_single_device(mesh_dp, use_natgrad):
    """The full data-parallel natgrad+Adam step with the kernel forced to
    engine='pallas': the normalisation diag of Kuf runs the fused diag
    kernel *inside shard_map*, at a per-shard batch of 2 sequences (well
    below the kernel's program block)."""
    rng = np.random.default_rng(5)
    N = 16
    X = jnp.asarray(_paths(rng, N, 6, 2))
    Y = jnp.asarray(rng.integers(0, 2, N))
    model = _make_model(rng, X)
    model = model.replace(kernel=model.kernel.replace(engine="pallas"))
    opt = optax.adam(1e-2)

    ref_step = make_step_fn(opt, num_data=N, gamma=0.1,
                            use_natgrad=use_natgrad)
    ref_state = init_state(model, opt)
    key = jax.random.PRNGKey(0)
    ref_state, ref_elbo = ref_step(ref_state, X, Y, key)
    ref_state, ref_elbo2 = ref_step(ref_state, X, Y, key)

    sh_step = make_sharded_step_fn(opt, num_data=N, mesh=mesh_dp, gamma=0.1,
                                   use_natgrad=use_natgrad)
    st = init_state(model, opt)
    Xs, Ys = meshlib.shard_batch(mesh_dp, X, Y)
    st, elbo = sh_step(st, Xs, Ys, key)
    st, elbo2 = sh_step(st, Xs, Ys, key)

    # single-device reference also runs the fused kernel (interpret), so
    # the only divergence is psum ordering + per-shard padding: tight tol
    np.testing.assert_allclose(float(elbo), float(ref_elbo), rtol=1e-6)
    np.testing.assert_allclose(float(elbo2), float(ref_elbo2), rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(st.model.q_mu), np.asarray(ref_state.model.q_mu),
        atol=1e-7,
    )
    np.testing.assert_allclose(
        np.asarray(st.model.kernel.raw_lengthscales),
        np.asarray(ref_state.model.kernel.raw_lengthscales), atol=1e-7,
    )


def test_sharded_step_runs_on_2d_mesh(mesh2d):
    """Same step on a (4, 2) mesh — tile axis unused by SVI but the specs
    must compose (the dryrun_multichip configuration)."""
    rng = np.random.default_rng(2)
    N = 8
    X = jnp.asarray(_paths(rng, N, 5, 2))
    Y = jnp.asarray(rng.integers(0, 2, N))
    model = _make_model(rng, X)
    opt = optax.adam(1e-2)
    step = make_sharded_step_fn(opt, num_data=N, mesh=mesh2d, gamma=0.1)
    st = init_state(model, opt)
    Xs, Ys = meshlib.shard_batch(mesh2d, X, Y)
    st, elbo = step(st, Xs, Ys, jax.random.PRNGKey(0))
    assert np.isfinite(float(elbo))
