"""Hand-rolled iterative multinomial NUTS with dual-averaging adaptation.

The reference has **no** MCMC path; BASELINE config 5 adds full-Bayes
inference over signature-kernel hyperparameters with chains sharded across
the mesh (SURVEY.md §2.4 'chain parallel'). TFP/blackjax are not available
on this image (SURVEY.md §7), so the sampler is implemented from scratch:

- multinomial NUTS (Betancourt 2017 / numpyro-style iterative tree
  doubling with checkpoint-based U-turn detection — no recursion, fixed
  ``max_depth``, jit/vmap/shard_map friendly),
- diagonal mass-matrix + step-size warmup (Welford estimator +
  Nesterov dual averaging, Stan-style windowing simplified to a single
  estimation window),
- chains vectorised with ``vmap``; cross-chain adaptation statistics can be
  ``psum``-reduced over the mesh's data axis (see
  ``gpsig/parallel/chains.py``).

Everything operates on flat parameter vectors; use ``ravel_pytree`` at the
call site.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.flatten_util import ravel_pytree  # noqa: F401  (re-export)


class NutsState(NamedTuple):
    theta: jnp.ndarray
    logp: jnp.ndarray
    grad: jnp.ndarray


class _TreeState(NamedTuple):
    # trajectory endpoints (left/right): position, momentum, grad
    theta_l: jnp.ndarray
    r_l: jnp.ndarray
    grad_l: jnp.ndarray
    theta_r: jnp.ndarray
    r_r: jnp.ndarray
    grad_r: jnp.ndarray
    # multinomial proposal
    theta_prop: jnp.ndarray
    logp_prop: jnp.ndarray
    grad_prop: jnp.ndarray
    log_weight: jnp.ndarray  # logsumexp of -energies in the tree
    # momentum sums for U-turn checks
    r_sum: jnp.ndarray
    turning: jnp.ndarray
    diverging: jnp.ndarray
    # acceptance statistics (for dual averaging)
    sum_accept: jnp.ndarray
    num_leaves: jnp.ndarray


def _leapfrog(logp_grad_fn, theta, r, grad, eps, inv_mass):
    r_half = r + 0.5 * eps * grad
    theta_new = theta + eps * inv_mass * r_half
    logp_new, grad_new = logp_grad_fn(theta_new)
    r_new = r_half + 0.5 * eps * grad_new
    return theta_new, r_new, logp_new, grad_new


def _kinetic(r, inv_mass):
    return 0.5 * jnp.sum(r * r * inv_mass)


def _is_turning(r_sum, r_first, r_last, inv_mass):
    """Generalised U-turn criterion on a trajectory segment."""
    v = inv_mass * r_sum
    return (jnp.dot(v, r_first) <= 0) | (jnp.dot(v, r_last) <= 0)


def nuts_kernel(
    logp_fn: Callable,
    max_depth: int = 8,
    max_delta_energy: float = 1000.0,
):
    """Returns step(key, state, step_size, inv_mass) -> (state, info)."""

    def logp_grad_fn(theta):
        return jax.value_and_grad(logp_fn)(theta)

    def step(key, state: NutsState, eps, inv_mass):
        dim = state.theta.shape[0]
        k_mom, k_dir, k_prop = jax.random.split(key, 3)
        r0 = jax.random.normal(k_mom, (dim,)) / jnp.sqrt(inv_mass)
        energy0 = -state.logp + _kinetic(r0, inv_mass)

        init = _TreeState(
            theta_l=state.theta, r_l=r0, grad_l=state.grad,
            theta_r=state.theta, r_r=r0, grad_r=state.grad,
            theta_prop=state.theta, logp_prop=state.logp,
            grad_prop=state.grad,
            log_weight=jnp.zeros(()),
            r_sum=r0,
            turning=jnp.zeros((), bool),
            diverging=jnp.zeros((), bool),
            sum_accept=jnp.zeros(()),
            num_leaves=jnp.zeros(()),
        )

        def cond(carry):
            depth, tree, _ = carry
            return (
                (depth < max_depth)
                & ~tree.turning
                & ~tree.diverging
            )

        def body(carry):
            depth, tree, key = carry
            key, k_dir, k_sub, k_merge = jax.random.split(key, 4)
            go_right = jax.random.bernoulli(k_dir)
            sub = _build_subtree(
                logp_grad_fn, tree, depth, go_right, eps, inv_mass,
                energy0, max_depth, max_delta_energy, k_sub,
            )
            # multinomial merge of proposals (biased progressive sampling)
            accept_logp = sub.log_weight - jnp.logaddexp(
                tree.log_weight, sub.log_weight
            )
            take_new = (
                jnp.log(jax.random.uniform(k_merge)) < accept_logp
            ) & ~sub.turning & ~sub.diverging
            theta_prop = jnp.where(take_new, sub.theta_prop, tree.theta_prop)
            logp_prop = jnp.where(take_new, sub.logp_prop, tree.logp_prop)
            grad_prop = jnp.where(take_new, sub.grad_prop, tree.grad_prop)

            theta_l = jnp.where(go_right, tree.theta_l, sub.theta_l)
            r_l = jnp.where(go_right, tree.r_l, sub.r_l)
            grad_l = jnp.where(go_right, tree.grad_l, sub.grad_l)
            theta_r = jnp.where(go_right, sub.theta_r, tree.theta_r)
            r_r = jnp.where(go_right, sub.r_r, tree.r_r)
            grad_r = jnp.where(go_right, sub.grad_r, tree.grad_r)

            r_sum = tree.r_sum + sub.r_sum
            turning_now = _is_turning(r_sum, r_l, r_r, inv_mass)
            valid_sub = ~sub.turning & ~sub.diverging
            new_tree = _TreeState(
                theta_l=theta_l, r_l=r_l, grad_l=grad_l,
                theta_r=theta_r, r_r=r_r, grad_r=grad_r,
                theta_prop=theta_prop, logp_prop=logp_prop,
                grad_prop=grad_prop,
                log_weight=jnp.logaddexp(
                    tree.log_weight,
                    jnp.where(valid_sub, sub.log_weight, -jnp.inf),
                ),
                r_sum=r_sum,
                turning=sub.turning | turning_now,
                diverging=sub.diverging,
                sum_accept=tree.sum_accept + sub.sum_accept,
                num_leaves=tree.num_leaves + sub.num_leaves,
            )
            return depth + 1, new_tree, key

        depth0 = jnp.zeros((), jnp.int32)
        _, tree, _ = lax.while_loop(cond, body, (depth0, init, k_dir))

        new_state = NutsState(tree.theta_prop, tree.logp_prop,
                              tree.grad_prop)
        accept_prob = tree.sum_accept / jnp.maximum(tree.num_leaves, 1.0)
        info = {
            "accept_prob": accept_prob,
            "diverging": tree.diverging,
            "num_leaves": tree.num_leaves,
            "energy": energy0,
        }
        return new_state, info

    return step


def _build_subtree(
    logp_grad_fn, tree, depth, go_right, eps, inv_mass, energy0,
    max_depth, max_delta_energy, key,
):
    """Build a subtree of 2^depth leaves by sequential leapfrogs with
    checkpoint-based U-turn detection (numpyro-style iterative scheme)."""
    num_leaves = jnp.asarray(2, jnp.int32) ** depth
    direction = jnp.where(go_right, 1.0, -1.0)
    theta0 = jnp.where(go_right, tree.theta_r, tree.theta_l)
    r0 = jnp.where(go_right, tree.r_r, tree.r_l)
    grad0 = jnp.where(go_right, tree.grad_r, tree.grad_l)
    dim = theta0.shape[0]

    # Checkpoint stacks for even-leaf states. Scheme (numpyro-style
    # binary-counter stack): even leaf i pushes (its momentum, the cumulative
    # momentum sum *before* it); odd leaf i completes ctz(i+1) aligned
    # subtrees whose leftmost leaves are the top ctz(i+1) stack entries —
    # check the generalised U-turn criterion on each segment, then pop
    # ctz(i+1) − 1 entries (the largest completed subtree's checkpoint stays
    # as the open-prefix representative).
    ck_r = jnp.zeros((max_depth + 1, dim), theta0.dtype)
    ck_csum = jnp.zeros((max_depth + 1, dim), theta0.dtype)

    class Carry(NamedTuple):
        i: jnp.ndarray
        theta: jnp.ndarray
        r: jnp.ndarray
        grad: jnp.ndarray
        theta_first: jnp.ndarray
        r_first: jnp.ndarray
        grad_first: jnp.ndarray
        theta_prop: jnp.ndarray
        logp_prop: jnp.ndarray
        grad_prop: jnp.ndarray
        log_weight: jnp.ndarray
        r_sum: jnp.ndarray
        ck_r: jnp.ndarray
        ck_csum: jnp.ndarray
        ck_top: jnp.ndarray
        turning: jnp.ndarray
        diverging: jnp.ndarray
        sum_accept: jnp.ndarray
        key: jnp.ndarray

    init = Carry(
        i=jnp.zeros((), jnp.int32),
        theta=theta0, r=r0, grad=grad0,
        theta_first=theta0, r_first=r0, grad_first=grad0,
        theta_prop=theta0, logp_prop=jnp.asarray(-jnp.inf, theta0.dtype),
        grad_prop=grad0,
        log_weight=jnp.asarray(-jnp.inf, theta0.dtype),
        r_sum=jnp.zeros_like(r0),
        ck_r=ck_r, ck_csum=ck_csum,
        ck_top=jnp.asarray(-1, jnp.int32),
        turning=jnp.zeros((), bool),
        diverging=jnp.zeros((), bool),
        sum_accept=jnp.zeros((), theta0.dtype),
        key=key,
    )

    def cond(c: Carry):
        return (c.i < num_leaves) & ~c.turning & ~c.diverging

    def body(c: Carry):
        key, k_prop = jax.random.split(c.key)
        # going left = flip momentum, integrate forward, flip back
        theta, r, logp, grad = _leapfrog(
            logp_grad_fn, c.theta, direction * c.r, c.grad, eps, inv_mass,
        )
        r = direction * r  # canonical orientation
        energy = -logp + _kinetic(r, inv_mass)
        delta = energy - energy0
        delta = jnp.where(jnp.isnan(delta), jnp.inf, delta)
        diverging = delta > max_delta_energy
        log_w = -delta
        accept = jnp.minimum(1.0, jnp.exp(-delta))

        new_log_weight = jnp.logaddexp(c.log_weight, log_w)
        take = jnp.log(jax.random.uniform(k_prop)) < (
            log_w - new_log_weight
        )
        theta_prop = jnp.where(take, theta, c.theta_prop)
        logp_prop = jnp.where(take, logp, c.logp_prop)
        grad_prop = jnp.where(take, grad, c.grad_prop)

        is_first = c.i == 0
        theta_first = jnp.where(is_first, theta, c.theta_first)
        r_first = jnp.where(is_first, r, c.r_first)
        grad_first = jnp.where(is_first, grad, c.grad_first)
        csum_before = c.r_sum
        r_sum = c.r_sum + r

        even = (c.i % 2) == 0
        ck_top_push = jnp.where(even, c.ck_top + 1, c.ck_top)
        slot = jnp.clip(ck_top_push, 0, max_depth)
        ck_r_n = jnp.where(even, c.ck_r.at[slot].set(r), c.ck_r)
        ck_csum_n = jnp.where(
            even, c.ck_csum.at[slot].set(csum_before), c.ck_csum
        )

        num_sub = jnp.where(even, 0, _ctz(c.i + 1, max_depth + 1))

        def turn_body(k, turning):
            idx = jnp.clip(ck_top_push - k, 0, max_depth)
            seg_sum = r_sum - ck_csum_n[idx]
            t = _is_turning(seg_sum, ck_r_n[idx], r, inv_mass)
            return turning | ((k < num_sub) & t)

        turning = lax.fori_loop(0, max_depth + 1, turn_body, c.turning)
        ck_top_new = ck_top_push - jnp.maximum(num_sub - 1, 0)

        return Carry(
            i=c.i + 1, theta=theta, r=r, grad=grad,
            theta_first=theta_first, r_first=r_first,
            grad_first=grad_first,
            theta_prop=theta_prop, logp_prop=logp_prop,
            grad_prop=grad_prop,
            log_weight=new_log_weight, r_sum=r_sum,
            ck_r=ck_r_n, ck_csum=ck_csum_n, ck_top=ck_top_new,
            turning=turning, diverging=c.diverging | diverging,
            sum_accept=c.sum_accept + accept, key=key,
        )

    out = lax.while_loop(cond, body, init)
    # endpoints in left/right orientation
    theta_l = jnp.where(go_right, out.theta_first, out.theta)
    r_l = jnp.where(go_right, out.r_first, out.r)
    grad_l = jnp.where(go_right, out.grad_first, out.grad)
    theta_r = jnp.where(go_right, out.theta, out.theta_first)
    r_r = jnp.where(go_right, out.r, out.r_first)
    grad_r = jnp.where(go_right, out.grad, out.grad_first)
    turning_total = out.turning | _is_turning(
        out.r_sum, r_l, r_r, inv_mass
    )
    return _TreeState(
        theta_l=theta_l, r_l=r_l, grad_l=grad_l,
        theta_r=theta_r, r_r=r_r, grad_r=grad_r,
        theta_prop=out.theta_prop, logp_prop=out.logp_prop,
        grad_prop=out.grad_prop,
        log_weight=out.log_weight, r_sum=out.r_sum,
        turning=turning_total, diverging=out.diverging,
        sum_accept=out.sum_accept,
        num_leaves=out.i.astype(out.theta.dtype),
    )


def _ctz(n, maxbits):
    """Count trailing zeros of a positive int32 scalar."""

    def body(k, carry):
        c, val = carry
        is_even = (val % 2) == 0
        c = jnp.where(is_even, c + 1, c)
        val = jnp.where(is_even, val // 2, val)
        return c, val

    c, _ = lax.fori_loop(
        0, maxbits, body, (jnp.zeros((), jnp.int32), n)
    )
    return c
