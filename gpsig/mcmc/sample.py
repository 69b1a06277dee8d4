"""NUTS drivers: warmup (dual averaging + Welford mass) and sampling.

Single-chain `run_nuts`, vmapped `run_chains`, and the cross-chain shared
adaptation hook used by the sharded multi-host path
(``gpsig/parallel/chains.py``): the dual-averaging statistic can be an
all-chain mean (one ``pmean`` per step) so every chain runs the same kernel
— the BASELINE config-5 "step-size adaptation via collectives".
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from gpsig.mcmc.nuts import NutsState, nuts_kernel


class DAState(NamedTuple):
    log_eps: jnp.ndarray
    log_eps_bar: jnp.ndarray
    h_bar: jnp.ndarray
    mu: jnp.ndarray
    t: jnp.ndarray


def da_init(eps0):
    log_eps = jnp.log(eps0)
    return DAState(
        log_eps=log_eps,
        log_eps_bar=jnp.zeros_like(log_eps),
        h_bar=jnp.zeros_like(log_eps),
        mu=jnp.log(10.0) + log_eps,
        t=jnp.zeros_like(log_eps),
    )


def da_update(state: DAState, accept_prob, target=0.8, gamma=0.05,
              t0=10.0, kappa=0.75):
    t = state.t + 1.0
    h_bar = (1.0 - 1.0 / (t + t0)) * state.h_bar + (
        target - accept_prob
    ) / (t + t0)
    log_eps = state.mu - jnp.sqrt(t) / gamma * h_bar
    w = t ** (-kappa)
    log_eps_bar = w * log_eps + (1.0 - w) * state.log_eps_bar
    return DAState(log_eps, log_eps_bar, h_bar, state.mu, t)


class WelfordState(NamedTuple):
    count: jnp.ndarray
    mean: jnp.ndarray
    m2: jnp.ndarray


def welford_init(dim, dtype):
    z = jnp.zeros((dim,), dtype)
    return WelfordState(jnp.zeros((), dtype), z, z)


def welford_update(state: WelfordState, x):
    n = state.count + 1.0
    delta = x - state.mean
    mean = state.mean + delta / n
    m2 = state.m2 + delta * (x - mean)
    return WelfordState(n, mean, m2)


def welford_variance(state: WelfordState, regularize=True):
    var = state.m2 / jnp.maximum(state.count - 1.0, 1.0)
    if regularize:  # Stan's shrinkage towards unit
        n = state.count
        var = (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))
    return var


def make_warm_step(kernel, target_accept, mass_start, mass_end,
                   cross_chain_mean=None):
    """One warmup iteration: NUTS transition + dual-averaging step-size
    update + Welford mass accumulation in [mass_start, mass_end).

    carry = (state, da, wf, inv_mass, key); scanned over the absolute
    warmup index t (so the same step function works for chunked scans —
    the mass-window logic keys on t, not the position within a chunk)."""

    def warm_step(carry, t):
        state, da, wf, inv_mass, key = carry
        key, sub = jax.random.split(key)
        eps = jnp.exp(da.log_eps)
        state, info = kernel(sub, state, eps, inv_mass)
        acc = info["accept_prob"]
        if cross_chain_mean is not None:
            acc = cross_chain_mean(acc)
        da = da_update(da, acc, target=target_accept)
        in_window = (t >= mass_start) & (t < mass_end)
        wf_new = welford_update(wf, state.theta)
        wf = jax.tree.map(
            lambda a, b: jnp.where(in_window, a, b), wf_new, wf
        )
        # at window end: freeze mass matrix, restart dual averaging
        at_end = t == mass_end
        inv_mass = jnp.where(at_end, welford_variance(wf), inv_mass)
        da_reset = da_init(jnp.exp(da.log_eps))
        da = jax.tree.map(
            lambda a, b: jnp.where(at_end, a, b), da_reset, da
        )
        return (state, da, wf, inv_mass, key), info["accept_prob"]

    return warm_step


def make_samp_step(kernel):
    """One sampling iteration. carry = (state, key, eps, inv_mass)."""

    def samp_step(carry, _):
        state, key, eps, inv_mass = carry
        key, sub = jax.random.split(key)
        state, info = kernel(sub, state, eps, inv_mass)
        out = {
            "theta": state.theta,
            "logp": state.logp,
            "accept_prob": info["accept_prob"],
            "diverging": info["diverging"],
            "num_leaves": info["num_leaves"],
        }
        return (state, key, eps, inv_mass), out

    return samp_step


def run_nuts(
    key,
    logp_fn: Callable,
    theta0,
    num_warmup=500,
    num_samples=500,
    max_depth=8,
    target_accept=0.8,
    init_step_size=0.1,
    cross_chain_mean: Callable | None = None,
):
    """Adaptive NUTS. Returns (samples [num_samples, D], info dict).

    cross_chain_mean: optional reduction applied to the accept statistic
    before dual averaging (e.g. ``lambda a: jax.lax.pmean(a, 'data')`` under
    shard_map, or a vmap-axis mean) — shares one step size across chains.
    """
    theta0 = jnp.asarray(theta0)
    dim = theta0.shape[0]
    dtype = theta0.dtype
    kernel = nuts_kernel(logp_fn, max_depth=max_depth)
    logp0, grad0 = jax.value_and_grad(logp_fn)(theta0)
    state0 = NutsState(theta0, logp0, grad0)

    mass_start = int(0.1 * num_warmup)
    mass_end = int(0.9 * num_warmup)
    warm_step = make_warm_step(kernel, target_accept, mass_start,
                               mass_end, cross_chain_mean)

    da0 = da_init(jnp.asarray(init_step_size, dtype))
    wf0 = welford_init(dim, dtype)
    inv_mass0 = jnp.ones((dim,), dtype)
    key, kw = jax.random.split(key)
    (state, da, _, inv_mass, _), warm_acc = lax.scan(
        warm_step, (state0, da0, wf0, inv_mass0, kw),
        jnp.arange(num_warmup),
    )
    eps = jnp.exp(da.log_eps_bar)
    samp_step = make_samp_step(kernel)
    (state, _, _, _), draws = lax.scan(
        samp_step, (state, key, eps, inv_mass), None, length=num_samples
    )
    info = {
        "step_size": eps,
        "inv_mass": inv_mass,
        "warmup_accept": warm_acc,
        "accept_prob": draws["accept_prob"],
        "diverging": draws["diverging"],
        "num_leaves": draws["num_leaves"],
        "logp": draws["logp"],
    }
    return draws["theta"], info


def run_chains(key, logp_fn, theta0s, share_step_size=False, **kw):
    """vmapped chains on one device. theta0s: [C, D]."""
    C = theta0s.shape[0]
    keys = jax.random.split(key, C)
    if share_step_size:
        kw = dict(kw, cross_chain_mean=None)  # vmap-mean not expressible;
        # sharded version in parallel/chains.py shares via pmean.
    f = jax.vmap(lambda k, t: run_nuts(k, logp_fn, t, **kw))
    return f(keys, theta0s)
