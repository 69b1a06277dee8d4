"""Tests for the Goursat PDE wavefront solver and its adjoint gradients."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gpsig.ops import goursat, signature as sig
from oracles import explicit_sig_kernel_levels, goursat_solve_naive


@pytest.mark.parametrize("shape", [(4, 4), (5, 3), (2, 7), (1, 1)])
def test_grid_matches_naive(shape):
    rng = np.random.default_rng(0)
    inc = 0.4 * rng.standard_normal(shape)
    got = np.asarray(goursat.goursat_grid(jnp.asarray(inc)))
    want = goursat_solve_naive(inc)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_corner_matches_grid_batched():
    rng = np.random.default_rng(1)
    inc = 0.3 * rng.standard_normal((3, 2, 6, 5))
    grid = goursat.goursat_grid(jnp.asarray(inc))
    corner = goursat.goursat_corner(jnp.asarray(inc))
    assert corner.shape == (3, 2)
    np.testing.assert_allclose(
        np.asarray(corner), np.asarray(grid[..., -1, -1]), rtol=1e-12
    )


@pytest.mark.parametrize("shape", [(4, 4), (5, 3), (3, 6)])
def test_adjoint_gradient_matches_autodiff(shape):
    rng = np.random.default_rng(2)
    inc = jnp.asarray(0.4 * rng.standard_normal(shape))

    def f_adjoint(a):
        return goursat.goursat_corner(a)

    def f_autodiff(a):
        return goursat.goursat_grid(a)[..., -1, -1]

    g1 = jax.grad(f_adjoint)(inc)
    g2 = jax.grad(f_autodiff)(inc)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), rtol=1e-9, atol=1e-12)


def test_adjoint_gradient_batched_weighted():
    rng = np.random.default_rng(3)
    inc = jnp.asarray(0.3 * rng.standard_normal((2, 4, 5)))
    w = jnp.asarray(rng.standard_normal(2))

    g1 = jax.grad(lambda a: jnp.sum(w * goursat.goursat_corner(a)))(inc)
    g2 = jax.grad(
        lambda a: jnp.sum(w * goursat.goursat_grid(a)[..., -1, -1])
    )(inc)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), rtol=1e-9, atol=1e-12)


def test_pde_converges_to_truncated_signature_kernel():
    """For smooth-ish paths the PDE solution should approach the exact
    (high-level truncated) signature kernel as dyadic refinement grows."""
    rng = np.random.default_rng(4)
    x = 0.3 * rng.standard_normal((5, 2)).cumsum(0)
    y = 0.3 * rng.standard_normal((6, 2)).cumsum(0)
    K = jnp.asarray(x @ y.T)
    inc = sig.incremental_gram(K)
    # ground truth: sum of exact signature levels (high truncation)
    want = explicit_sig_kernel_levels(x, y, 12).sum()
    errs = []
    for o in [0, 2, 4]:
        got = float(goursat.signature_kernel_pde(inc, dyadic_order=o))
        errs.append(abs(got - want))
    assert errs[1] < errs[0]
    assert errs[2] < errs[1]
    assert errs[2] < 1e-3 * max(1.0, abs(want))


def test_refine_increments_preserves_total():
    rng = np.random.default_rng(5)
    inc = jnp.asarray(rng.standard_normal((3, 4)))
    r = goursat.refine_increments(inc, 2)
    assert r.shape == (12, 16)
    np.testing.assert_allclose(float(r.sum()), float(inc.sum()), rtol=1e-12)


def test_corner_refined_custom_vjp_cpu_fallback():
    """The public PDE entry point routes primal+grad through the scan and
    its adjoint; values and gradients must match the composed reference
    exactly."""
    rng = np.random.default_rng(9)
    inc = jnp.asarray(0.3 * rng.standard_normal((2, 6, 5)), jnp.float64)
    f_new = lambda a: jnp.sum(goursat.signature_kernel_pde(a, 2))  # noqa
    f_ref = lambda a: jnp.sum(  # noqa
        goursat.goursat_corner(goursat.refine_increments(a, 2))
    )
    np.testing.assert_allclose(np.asarray(f_new(inc)),
                               np.asarray(f_ref(inc)), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(jax.grad(f_new)(inc)),
                               np.asarray(jax.grad(f_ref)(inc)), rtol=1e-10)
