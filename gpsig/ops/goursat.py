"""Untruncated signature kernel via the Goursat PDE (wavefront solve).

Re-design of the reference fork's CUDA wavefront solver
(reference: SigGPDE — ``gpsig/kernels_pde.py`` + the CUDA ``.cu`` op; see
SURVEY.md §2.2 / §3.4; algorithm from Lemercier et al., ICML 2021,
arXiv:2105.04211). The reference launches one CUDA block per sequence pair
and sweeps antidiagonals with one thread per cell. Here the same wavefront is
expressed as a `lax.scan` over antidiagonals of a *skewed* layout, vectorised
over (batch × diagonal-cells) so each step is one fused elementwise op over
the whole pair batch. This scan is the solver on every backend; a wavefront
kernel in the reference op's shape is a later step (ROADMAP).

Math: k_sig(x, y) = u(S, T) where u solves the Goursat problem

    ∂²u/∂s∂t = ⟨ẋ_s, ẏ_t⟩ u,   u(0, ·) = u(·, 0) = 1,

discretised on the (S+1)×(T+1) grid with the explicit midpoint scheme

    u[i+1,j+1] = u[i+1,j] + u[i,j+1] - u[i,j]
                 + inc[i,j] · (u[i+1,j] + u[i,j+1]) / 2

with inc[i,j] = ⟨δx_i, δy_j⟩ (double-differenced base-kernel Gram), and the
grid optionally refined 2^dyadic_order × per step.

Gradients: following the reference, the backward pass solves the *adjoint*
Goursat recursion by a second (reversed) wavefront sweep instead of
differentiating through the forward sweep:

    μ[i,j] = -μ[i+1,j+1] + μ[i,j+1]·(1 + inc[i-1,j]/2)
             + μ[i+1,j]·(1 + inc[i,j-1]/2),        μ[S,T] = ḡ,

    ∂u(S,T)/∂inc[i,j] = μ[i+1,j+1] · (u[i+1,j] + u[i,j+1]) / 2.

Implemented as a `jax.custom_vjp`; parity with autodiff-through-scan is
covered by tests.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def refine_increments(inc, dyadic_order):
    """Refine the increment grid 2^o × per axis (each sub-cell gets inc/4^o)."""
    if dyadic_order <= 0:
        return inc
    f = 2**dyadic_order
    inc = jnp.repeat(inc, f, axis=-2)
    inc = jnp.repeat(inc, f, axis=-1)
    return inc / (f * f)


def _skewpad(inc):
    """Skew inc [..., S, T] into [..., S+1, S+T-1] with
    out[..., i+1, i+j] = inc[..., i, j] (zero elsewhere).

    Column c then holds antidiagonal i+j = c of inc, pre-shifted down by one
    row so that position i of the column is inc[i-1, c-(i-1)] — exactly the
    alignment the wavefront update needs.
    """
    S, T = inc.shape[-2], inc.shape[-1]
    C = S + T - 1
    # out[i, c] = inc[i-1, c-i+1] where valid
    i_idx = jnp.arange(S + 1)[:, None]
    c_idx = jnp.arange(C)[None, :]
    j_idx = c_idx - (i_idx - 1)
    valid = (i_idx >= 1) & (j_idx >= 0) & (j_idx < T)
    gather_rows = jnp.clip(i_idx - 1, 0, S - 1)
    gather_cols = jnp.clip(j_idx, 0, T - 1)
    out = inc[..., gather_rows, gather_cols]
    return jnp.where(valid, out, jnp.zeros((), inc.dtype))


def _forward_scan(inc):
    """Wavefront forward solve. Returns skewed u diagonals
    U_sk: [S+T, ..., S+1] holding antidiagonals d = 1..S+T of the solution
    grid (U_sk[d-1, ..., i] = u[i, d-i]), plus the corner u[S, T]."""
    S, T = inc.shape[-2], inc.shape[-1]
    batch = inc.shape[:-2]
    dtype = inc.dtype
    sk = _skewpad(inc)  # [..., S+1, S+T-1]
    cols = jnp.moveaxis(sk, -1, 0)  # [S+T-1, ..., S+1]
    i_iota = jnp.arange(S + 1)
    i_b = i_iota.reshape((S + 1,) + (1,) * 0)

    # diag 0: u[0,0]=1 at i=0 ; diag 1: u[0,1], u[1,0] = 1
    d0 = jnp.zeros(batch + (S + 1,), dtype).at[..., 0].set(1.0)
    d1 = jnp.zeros(batch + (S + 1,), dtype)
    d1 = d1.at[..., 0].set(1.0 if T >= 1 else 0.0)
    if S >= 1:
        d1 = d1.at[..., 1].set(1.0)

    ds = jnp.arange(2, S + T + 1)

    def step(carry, xs):
        prev, prev2 = carry  # diag d-1, diag d-2
        acol, d = xs  # acol[i] = inc[i-1, d-i-1] (already aligned), scalar d
        prev_sh = jnp.roll(prev, 1, axis=-1)
        prev2_sh = jnp.roll(prev2, 1, axis=-1)
        upd = prev + prev_sh - prev2_sh + acol * (prev + prev_sh) * 0.5
        interior = (
            (i_b >= jnp.maximum(1, d - T)) & (i_b <= jnp.minimum(S, d - 1))
        )
        curr = jnp.where(interior, upd, jnp.zeros((), dtype))
        curr = jnp.where((i_b == 0) & (d <= T), jnp.ones((), dtype), curr)
        curr = jnp.where(i_b == d, jnp.ones((), dtype), curr)
        return (curr, prev), curr

    (_, _), diags = lax.scan(step, (d1, d0), (cols, ds))
    u_sk = jnp.concatenate([d1[None], diags], axis=0)  # diags 1..S+T
    corner = diags[-1][..., S]
    return u_sk, corner


def _unskew(u_sk, S, T):
    """Dense u grid [..., S+1, T+1] from skewed diagonals [S+T, ..., S+1]."""
    dtype = u_sk.dtype
    dense = jnp.moveaxis(u_sk, 0, -2)  # [..., S+1(i), ...]? -> [..., S+T, S+1]
    batch = dense.shape[:-2]
    I = jnp.arange(S + 1)[:, None]
    J = jnp.arange(T + 1)[None, :]
    D = I + J - 1  # diagonal index into axis of length S+T (diags 1..S+T)
    Dc = jnp.clip(D, 0, S + T - 1)
    flat = dense.reshape(batch + ((S + T) * (S + 1),))
    idx = (Dc * (S + 1) + I).reshape(-1)
    u = jnp.take(flat, idx, axis=-1).reshape(batch + (S + 1, T + 1))
    u = u.at[..., 0, 0].set(1.0)  # D=-1 cell
    return u


def goursat_grid(inc):
    """Full Goursat solution grid u [..., S+1, T+1] (autodiff-friendly)."""
    S, T = inc.shape[-2], inc.shape[-1]
    u_sk, _ = _forward_scan(inc)
    return _unskew(u_sk, S, T)


@jax.custom_vjp
def goursat_corner(inc):
    """u(S, T) for inc [..., S, T] → [...]. Custom adjoint-PDE gradient."""
    _, corner = _forward_scan(inc)
    return corner


def _corner_fwd(inc):
    u_sk, corner = _forward_scan(inc)
    return corner, (inc, u_sk)


def _adjoint_scan(inc, gbar):
    """Reverse wavefront solving the adjoint recursion; returns dense μ grid
    [..., S+1, T+1] (zero on the i=0 / j=0 boundaries)."""
    S, T = inc.shape[-2], inc.shape[-1]
    batch = gbar.shape
    dtype = inc.dtype
    sk = _skewpad(inc)  # [..., S+1, S+T-1]; col c at pos i = inc[i-1, c-i+1]
    cols = jnp.moveaxis(sk, -1, 0)
    i_b = jnp.arange(S + 1)

    # μ diag d holds μ[i, d-i] for 1 <= i <= S, 1 <= d-i <= T.
    # Recursion (interior): μ[i,j] = -μ[i+1,j+1] + μ[i,j+1]·(1+inc[i-1,j]/2)
    #                                + μ[i+1,j]·(1+inc[i,j-1]/2)
    # diag coords: μ[i+1,j+1] → diag d+2 pos i+1; μ[i,j+1] → diag d+1 pos i;
    # μ[i+1,j] → diag d+1 pos i+1.
    # inc[i-1, j] with j = d-i: skewpad col (i-1)+(d-i) = d-1 at pos i.
    # inc[i, j-1]: skewpad col i+(d-i-1) = d-1 at pos i+1.
    top = jnp.zeros(batch + (S + 1,), dtype).at[..., S].set(gbar)  # diag S+T
    zero = jnp.zeros(batch + (S + 1,), dtype)

    ds = jnp.arange(S + T - 1, 1, -1)  # compute diags S+T-1 .. 2
    # for diag d we need skewpad column d-1 → columns S+T-2 .. 1
    acols = cols[1:][::-1]  # cols index c=d-1 → cols[d-1-?]: cols axis0 index = c
    # cols has columns c = 0..S+T-2 ; for d in ds, c = d-1 runs S+T-2..1
    # cols[1:] = c=1..S+T-2 ; reversed → S+T-2..1. Correct.

    def step(carry, xs):
        nxt, nxt2 = carry  # μ diag d+1, d+2
        acol, d = xs  # acol pos i = inc[i-1, d-i]
        a_up = jnp.roll(acol, -1, axis=-1)  # pos i = inc[i, d-i-1]
        nxt_up = jnp.roll(nxt, -1, axis=-1)  # pos i = μ diag d+1 pos i+1
        nxt2_up = jnp.roll(nxt2, -1, axis=-1)  # pos i = μ diag d+2 pos i+1
        upd = (
            -nxt2_up
            + nxt * (1.0 + 0.5 * acol)
            + nxt_up * (1.0 + 0.5 * a_up)
        )
        interior = (
            (i_b >= jnp.maximum(1, d - T)) & (i_b <= jnp.minimum(S, d - 1))
        )
        curr = jnp.where(interior, upd, jnp.zeros((), dtype))
        return (curr, nxt), curr

    (_, _), diags = lax.scan(step, (top, zero), (acols, ds))
    # diags are μ antidiagonals S+T-1 .. 2 ; assemble μ_sk diags 1..S+T:
    mu_sk = jnp.concatenate(
        [zero[None], diags[::-1], top[None]], axis=0
    )  # diag 1, diags 2..S+T-1, diag S+T
    return _unskew_mu(mu_sk, S, T)


def _unskew_mu(mu_sk, S, T):
    mu = _unskew(mu_sk, S, T)
    # boundary μ values are not defined by the recursion; zero them.
    mu = mu.at[..., 0, :].set(0.0)
    mu = mu.at[..., :, 0].set(0.0)
    return mu


def _corner_bwd(res, gbar):
    inc, u_sk = res
    S, T = inc.shape[-2], inc.shape[-1]
    u = _unskew(u_sk, S, T)
    mu = _adjoint_scan(inc, gbar)
    # ∂corner/∂inc[i,j] = μ[i+1,j+1] · (u[i+1,j] + u[i,j+1]) / 2
    grad = mu[..., 1:, 1:] * (u[..., 1:, :-1] + u[..., :-1, 1:]) * 0.5
    return (grad,)


goursat_corner.defvjp(_corner_fwd, _corner_bwd)


def signature_kernel_pde(inc, dyadic_order=0):
    """Untruncated signature kernel from a raw increment grid.

    inc: [..., Lx-1, Ly-1] increment inner products (double-differenced
    base-kernel Gram). Returns [...] kernel values: the corner of the
    ``lax.scan`` wavefront solve on the grid refined 2^dyadic_order× per
    axis, with the adjoint-PDE gradient of :func:`goursat_corner`.
    """
    return goursat_corner(refine_increments(inc, dyadic_order))
