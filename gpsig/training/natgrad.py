"""Natural-gradient optimisation of Gaussian variational parameters.

Re-implements GPflow 1.x's ``NatGradOptimizer`` (+ ``XiSqrtMeanVar``
transform) — the dependency-owned optimiser the reference's benchmarks
alternate with Adam (SURVEY.md §2.3 / §3.1): natural-gradient steps on
(q_mu, q_sqrt) with hyperparameters held fixed, Adam on everything else.

Math. For q(u) = N(μ, S) the natural-gradient ascent step of length γ in
natural parameters (θ₁, θ₂) = (S⁻¹μ, −½S⁻¹) equals, via the chain rule to
expectation parameters (η₁, η₂) = (μ, S + μμᵀ):

    ∂L/∂η₁ = g_μ − 2 g_S μ,      ∂L/∂η₂ = g_S,

    θ₂' = θ₂ + γ g_S   ⇒  S'⁻¹ = S⁻¹ − 2γ g_S
    θ₁' = θ₁ + γ ∂L/∂η₁ ⇒  μ'   = S' (S⁻¹μ + γ(g_μ − 2 g_S μ))

where g_μ = ∂L/∂μ and g_S = ∂L/∂S is the *symmetric* gradient (autodiff
through chol(S) yields a lower-triangular gradient; symmetrise with
(G + Gᵀ)/2). The same formulas hold elementwise for diagonal q (the VOSF
path where they cost O(M)).

Stability: S'⁻¹ must stay positive-definite; the standard practice (and the
reference benchmarks') is small γ (0.01–0.1) warm-up. We add `jitter` to the
precision before the solve as a guard.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import scipy as jsp

from gpsig.config import precise_linalg


def _elbo_mean_cov(model, mu, cov_or_s2, X, Y, num_data, key, diag):
    if diag:
        q_sqrt = jnp.sqrt(cov_or_s2)  # [M, C]
        m = model.replace(q_mu=mu, q_sqrt=q_sqrt)
    else:
        L = jnp.linalg.cholesky(cov_or_s2)  # [C, M, M]
        m = model.replace(q_mu=mu, q_sqrt=L)
    return m.elbo(X, Y, num_data=num_data, key=key)


#: backoff factors tried when S'⁻¹ = S⁻¹ − 2γ g_S is not positive-definite
#: (γ too aggressive for the current curvature — the standard failure mode
#: of non-conjugate natural gradients; GPflow warm-ups γ instead).
_BACKOFF = (1.0, 0.25, 0.0625, 0.015625)


@precise_linalg
def gaussian_natgrad_update(mu, S, g_mu, g_S, gamma, jitter=1e-8,
                            diag=False):
    """Apply the natural-gradient step in (μ, S); returns (μ', q_sqrt').

    Full-covariance path tries γ·{1, ¼, 1/16, 1/64} and keeps the largest
    step whose new precision stays Cholesky-factorisable (per latent);
    falls back to no-op if all fail."""
    if diag:
        # same per-latent γ-backoff as the full-covariance path: a flat
        # floor on the new precision is NOT enough — one aggressive
        # non-conjugate step (g_S > prec/2γ, routine for MultiClass at
        # init with minibatch scaling) would pin the precision at the
        # floor, inflate S by orders of magnitude and explode the KL
        # (observed: ELBO -1e19 at step 0 on the VOSF/q_diag path).
        prec = 1.0 / S
        mu_out, s_out = mu, S
        done = jnp.zeros((mu.shape[1],), bool)
        for scale in _BACKOFF:
            g = gamma * scale
            prec_new = prec - 2.0 * g * g_S
            ok = jnp.all(prec_new > jitter, axis=0)  # [C]
            S_new = 1.0 / jnp.maximum(prec_new, jitter)
            mu_new = S_new * (prec * mu + g * (g_mu - 2.0 * g_S * mu))
            take = ok & ~done
            mu_out = jnp.where(take[None, :], mu_new, mu_out)
            s_out = jnp.where(take[None, :], S_new, s_out)
            done = done | ok
        return mu_out, jnp.sqrt(s_out)

    g_S = 0.5 * (g_S + jnp.swapaxes(g_S, -1, -2))
    M = mu.shape[0]
    eye = jnp.eye(M, dtype=mu.dtype)
    Ls = jnp.linalg.cholesky(S)
    Sinv = jax.vmap(lambda Lc: jsp.linalg.cho_solve((Lc, True), eye))(Ls)
    theta1 = jnp.einsum("cij,jc->ic", Sinv, mu)  # S⁻¹μ, [M, C]

    def attempt(scale):
        g = gamma * scale
        prec_new = Sinv - 2.0 * g * g_S + jitter * eye
        Lp = jnp.linalg.cholesky(prec_new)
        ok = jnp.all(jnp.isfinite(jnp.diagonal(Lp, axis1=-2, axis2=-1)),
                     axis=-1)  # [C]
        S_new = jax.vmap(
            lambda Lc: jsp.linalg.cho_solve((Lc, True), eye)
        )(jnp.where(ok[:, None, None], Lp, eye[None]))
        th1 = theta1 + g * (
            g_mu - 2.0 * jnp.einsum("cij,jc->ic", g_S, mu)
        )
        mu_new = jnp.einsum("cij,jc->ic", S_new, th1)
        q_new = jnp.linalg.cholesky(
            0.5 * (S_new + jnp.swapaxes(S_new, -1, -2)) + jitter * eye
        )
        ok = ok & jnp.all(
            jnp.isfinite(jnp.diagonal(q_new, axis1=-2, axis2=-1)), axis=-1
        ) & jnp.all(jnp.isfinite(mu_new), axis=0)
        return ok, mu_new, q_new

    mu_out = mu
    q_out = Ls
    done = jnp.zeros((mu.shape[1],), bool)
    for scale in _BACKOFF:
        ok, mu_new, q_new = attempt(scale)
        take = ok & ~done
        mu_out = jnp.where(take[None, :], mu_new, mu_out)
        q_out = jnp.where(take[:, None, None], q_new, q_out)
        done = done | ok
    return mu_out, q_out


def natgrad_step(model, gamma, X, Y, num_data=None, key=None, jitter=1e-8):
    """One natural-gradient ascent step on (q_mu, q_sqrt); returns the
    updated model. Hyperparameters are untouched."""
    diag = model.q_diag
    mu = model.q_mu  # [M, C]
    if diag:
        S = model.q_sqrt**2  # [M, C]
    else:
        Lq = jnp.tril(model.q_sqrt)  # [C, M, M]
        S = jnp.einsum("cij,ckj->cik", Lq, Lq)

    g_mu, g_S = jax.grad(
        lambda m_, S_: _elbo_mean_cov(model, m_, S_, X, Y, num_data, key, diag),
        argnums=(0, 1),
    )(mu, S)

    mu_new, q_sqrt_new = gaussian_natgrad_update(
        mu, S, g_mu, g_S, gamma, jitter, diag
    )
    return model.replace(q_mu=mu_new, q_sqrt=q_sqrt_new)
