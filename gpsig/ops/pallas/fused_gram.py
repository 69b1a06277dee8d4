"""Fused order-1 signature Gram: base kernel + double difference + per-level
DP in one Pallas kernel through Triton, nothing O(N²L²) in device memory.

The plain XLA path (``SignatureKernel`` with ``engine='xla'``) builds the
increment tensor M[N1, N2, L-1, L-1] and runs two exclusive cumsums over it
per level. That is elementwise work far below the card's ridge point, so it
is bound by device-memory traffic on the [N², L²] tensor. This kernel moves
only X, Y and the [levels, N1, N2] result.

Layout: a program owns one x-sequence against ``_BLOCK_Y`` y-sequences (the
diagonal variant: ``_BLOCK_Y`` sequences against themselves). Pairs are
independent, so programs run in any order on any SM with nothing carried
between them. Inside a program a ``fori_loop`` walks the L2-1 columns of the
(virtual) increment matrix; per column it

- builds the base-kernel columns k(x_i, y_j), k(x_i, y_{j+1}) and the same
  for x_{i+1} from the raw sequences (d FMAs and one exp each; for RBF the
  wrapper packs −½‖·‖² as an extra channel so the exponent is pure FMAs),
- double-differences them into the increment column M[:, j] (rows are
  lanes of a [_BLOCK_Y, Lp] register tile), and
- advances the running column sums C_m[i] = Σ_{j'<j} A_m[i, j'] with
  A_1 = M, A_m[:, j] = M[:, j] ⊙ excl-cumsum_i(C_{m-1}) (a native
  ``jnp.cumsum`` over the row axis).

Level m's kernel value is Σ_i C_m[i] after the last column. The x row axis
is padded to a power of two Lp by repeating the last observation, which
gives zero increments that the recursion ignores.

The gradient is a ``custom_vjp`` whose backward differentiates the
mathematically identical XLA recompute, row-blocked so the [rb, N2, L, L]
intermediates stay bounded.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from gpsig.ops import signature as sigops

#: y-sequences per program and warps per program, tuned on an H100 (400 W
#: limit) at N=256, L=50, d=2, nl=4: of block_y ∈ {16, 32, 64, 128} ×
#: warps ∈ {4, 8}, (32, 8) was fastest for the Gram and (32, 4) for the
#: diagonal (PERF.md, PR 1).
_BLOCK_Y = 32
_NUM_WARPS = 8
_NUM_WARPS_DIAG = 4
#: most x-rows per backward recompute block: bounds the [rb, N2, L, L]
#: tensors, and at N=256, L=50 the blocked recompute measured faster than
#: the unblocked XLA gradient on an H100 (PERF.md, PR 1)
_BWD_ROW_BLOCK = 64


def _levels_kernel(x_ref, y_ref, out_ref, *, n_cols, d, num_levels, rbf,
                   diag):
    """x_ref: [bx, 2, dc, Lp] (rows i and i+1 of bx x-sequences, bx = 1 or
    _BLOCK_Y); y_ref: [L2, dc, _BLOCK_Y]; out_ref: [num_levels, 1,
    _BLOCK_Y] (Gram) or [num_levels, _BLOCK_Y] (diag). dc = d (+1 for
    RBF)."""
    dc = d + 1 if rbf else d
    if diag:
        xs = [[x_ref[:, s, c, :] for c in range(dc)] for s in range(2)]
    else:
        xs = [[x_ref[0, s, c, :][None, :] for c in range(dc)]
              for s in range(2)]

    def kcols(j):
        """k(x_i, y_j) and k(x_{i+1}, y_j): two [_BLOCK_Y, Lp] tiles."""
        y = [y_ref[j, c, :][:, None] for c in range(dc)]
        out = []
        for s in range(2):
            g = xs[s][d] + y[d] if rbf else xs[s][0] * y[0]
            for c in range(0 if rbf else 1, d):
                g = g + xs[s][c] * y[c]
            out.append(jnp.exp(g) if rbf else g)
        return out

    k_lo, k_hi = kcols(0)
    C = [jnp.zeros(k_lo.shape, k_lo.dtype) for _ in range(num_levels)]

    def body(j, carry):
        k_lo, k_hi, C = carry
        n_lo, n_hi = kcols(j + 1)
        M = (n_hi - n_lo) - (k_hi - k_lo)
        new = [C[0] + M]
        for m in range(1, num_levels):
            excl = jnp.cumsum(C[m - 1], axis=1) - C[m - 1]
            new.append(C[m] + M * excl)
        return n_lo, n_hi, new

    _, _, C = jax.lax.fori_loop(0, n_cols, body, (k_lo, k_hi, C))
    for m in range(num_levels):
        if diag:
            out_ref[m, :] = jnp.sum(C[m], axis=1)
        else:
            out_ref[m, 0, :] = jnp.sum(C[m], axis=1)


def _pack(Z, rbf):
    """[N, L, d] → [N, L, dc] with −½‖z‖² appended for RBF."""
    if rbf:
        Z = jnp.concatenate([Z, -0.5 * jnp.sum(Z * Z, -1, keepdims=True)],
                            axis=-1)
    return Z


def _pack_rows(X, rbf):
    """[N, L, d] → [N, 2, dc, Lp]: rows i and i+1, Lp a power of two,
    padded by repeating the last observation (zero increments)."""
    N, L, _ = X.shape
    Lp = pl.next_power_of_2(max(L, 2))
    Xr = jnp.concatenate([X, jnp.repeat(X[:, -1:], Lp + 1 - L, axis=1)],
                         axis=1)
    Xr = _pack(Xr, rbf)
    return jnp.stack([Xr[:, :Lp], Xr[:, 1:]], axis=1).transpose(0, 1, 3, 2)


def _pad_cols(Y):
    """[N, L, dc] → [L, dc, Np] with N padded to a multiple of _BLOCK_Y."""
    N = Y.shape[0]
    Np = -(-N // _BLOCK_Y) * _BLOCK_Y
    return jnp.pad(Y, ((0, Np - N), (0, 0), (0, 0))).transpose(1, 2, 0)


def _compiler_params(num_warps):
    return plgpu.CompilerParams(num_warps=num_warps, num_stages=1)


def _gram_call(X, Y, num_levels, rbf, interpret=False):
    """Forward kernel call: [nl+1, N1, N2] (level 0 = 1)."""
    N1, L1, d = X.shape
    N2, L2, _ = Y.shape
    Xk = _pack_rows(X, rbf)
    Yt = _pad_cols(_pack(Y, rbf))
    dc, Lp = Xk.shape[2], Xk.shape[3]
    N2p = Yt.shape[-1]
    by = _BLOCK_Y
    out = pl.pallas_call(
        functools.partial(_levels_kernel, n_cols=L2 - 1, d=d,
                          num_levels=num_levels, rbf=rbf, diag=False),
        grid=(N1, N2p // by),
        in_specs=[
            pl.BlockSpec((1, 2, dc, Lp), lambda i, j: (i, 0, 0, 0)),
            pl.BlockSpec((L2, dc, by), lambda i, j: (0, 0, j)),
        ],
        out_specs=pl.BlockSpec((num_levels, 1, by), lambda i, j: (0, i, j)),
        out_shape=jax.ShapeDtypeStruct((num_levels, N1, N2p), X.dtype),
        backend="triton",
        compiler_params=_compiler_params(_NUM_WARPS),
        interpret=interpret,
        name="sig_gram_levels",
    )(Xk, Yt)
    ones = jnp.ones((1, N1, N2), X.dtype)
    return jnp.concatenate([ones, out[:, :, :N2]], axis=0)


def _diag_call(X, num_levels, rbf, interpret=False):
    """Self-pair forward: [nl+1, N] per-level k_m(x_n, x_n)."""
    N, L, d = X.shape
    by = _BLOCK_Y
    Np = -(-N // by) * by
    Xp = jnp.pad(X, ((0, Np - N), (0, 0), (0, 0)))
    Xk = _pack_rows(Xp, rbf)
    Yt = _pad_cols(_pack(Xp, rbf))
    dc, Lp = Xk.shape[2], Xk.shape[3]
    out = pl.pallas_call(
        functools.partial(_levels_kernel, n_cols=L - 1, d=d,
                          num_levels=num_levels, rbf=rbf, diag=True),
        grid=(Np // by,),
        in_specs=[
            pl.BlockSpec((by, 2, dc, Lp), lambda j: (j, 0, 0, 0)),
            pl.BlockSpec((L, dc, by), lambda j: (0, 0, j)),
        ],
        out_specs=pl.BlockSpec((num_levels, by), lambda j: (0, j)),
        out_shape=jax.ShapeDtypeStruct((num_levels, Np), X.dtype),
        backend="triton",
        compiler_params=_compiler_params(_NUM_WARPS_DIAG),
        interpret=interpret,
        name="sig_diag_levels",
    )(Xk, Yt)
    return jnp.concatenate([jnp.ones((1, N), X.dtype), out[:, :N]], axis=0)


def _base_gram(a, b, rbf):
    """Base Gram in the kernel's own (unclamped) form, so the custom VJP
    differentiates exactly the function the forward computes."""
    g = jnp.matmul(a, jnp.swapaxes(b, -1, -2), precision="highest")
    if not rbf:
        return g
    na = jnp.sum(a * a, -1)
    nb = jnp.sum(b * b, -1)
    return jnp.exp(g - 0.5 * (na[..., :, None] + nb[..., None, :]))


def xla_levels(X, Y, num_levels, rbf):
    """Plain XLA reference of :func:`fused_gram_levels` (the VJP route)."""
    N1, L1, d = X.shape
    N2, L2, _ = Y.shape
    G = _base_gram(X.reshape(N1 * L1, d), Y.reshape(N2 * L2, d), rbf)
    G = G.reshape(N1, L1, N2, L2).transpose(0, 2, 1, 3)
    return sigops.signature_kern(sigops.incremental_gram(G), num_levels)


def xla_diag_levels(X, num_levels, rbf):
    """Plain XLA reference of :func:`fused_diag_levels`."""
    G = _base_gram(X, X, rbf)
    return sigops.signature_kern(sigops.incremental_gram(G), num_levels)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3, 4))
def fused_gram_levels(X, Y, num_levels, rbf=True, interpret=False):
    """[nl+1, N1, N2] per-level order-1 signature kernels, fully fused.

    X: [N1, L1, d], Y: [N2, L2, d] — pre-scaled sequences (order 1,
    difference=True semantics); ``rbf`` selects the RBF base kernel (else
    linear). ``interpret`` runs the kernel in the Pallas interpreter (for
    the CPU; the GPU always runs the compiled kernel)."""
    return _gram_call(X, Y, num_levels, rbf, interpret)


def _gram_fwd(X, Y, num_levels, rbf, interpret):
    return _gram_call(X, Y, num_levels, rbf, interpret), (X, Y)


def _gram_bwd(num_levels, rbf, interpret, res, g):
    del interpret
    X, Y = res
    N1 = X.shape[0]
    if N1 <= _BWD_ROW_BLOCK:
        _, vjp = jax.vjp(lambda x, y: xla_levels(x, y, num_levels, rbf),
                         X, Y)
        return vjp(g)
    # equal blocks of at most _BWD_ROW_BLOCK rows, padded by < nblk rows
    nblk = -(-N1 // _BWD_ROW_BLOCK)
    rb = -(-N1 // nblk)
    pad = nblk * rb - N1
    Xp = jnp.pad(X, ((0, pad), (0, 0), (0, 0)))
    gp = jnp.pad(g, ((0, 0), (0, pad), (0, 0)))
    xblocks = Xp.reshape(-1, rb, *X.shape[1:])
    gblocks = jnp.moveaxis(gp.reshape(g.shape[0], -1, rb, g.shape[2]), 1, 0)

    def block_vjp(args):
        xb, gb = args
        _, vjp = jax.vjp(lambda x, y: xla_levels(x, y, num_levels, rbf),
                         xb, Y)
        return vjp(gb)

    xbar, ybar = jax.lax.map(block_vjp, (xblocks, gblocks))
    return xbar.reshape(-1, *X.shape[1:])[:N1], jnp.sum(ybar, axis=0)


fused_gram_levels.defvjp(_gram_fwd, _gram_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(1, 2, 3))
def fused_diag_levels(X, num_levels, rbf=True, interpret=False):
    """[nl+1, N] per-level self kernels k_m(x_n, x_n), fully fused."""
    return _diag_call(X, num_levels, rbf, interpret)


def _diag_fwd(X, num_levels, rbf, interpret):
    return _diag_call(X, num_levels, rbf, interpret), X


def _diag_bwd(num_levels, rbf, interpret, X, g):
    del interpret
    _, vjp = jax.vjp(lambda x: xla_diag_levels(x, num_levels, rbf), X)
    return vjp(g)


fused_diag_levels.defvjp(_diag_fwd, _diag_bwd)
