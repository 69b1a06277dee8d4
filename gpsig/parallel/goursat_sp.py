"""Sequence-parallel (context-parallel) Goursat solve with halo exchange.

SURVEY.md §2.4/§5.7: for sequences too long for one chip, the (s, t) PDE
grid is sharded along s across the mesh's ``data`` axis and solved as a
*device wavefront pipeline*: device p owns a block of rows; the solve
proceeds in column blocks (supersteps), and after each superstep device p
ships its bottom boundary row to device p+1 (`lax.ppermute`, NVLink) —
the reference's CUDA intra-kernel wavefront lifted to the chip level.

Local tiles solve with general boundary conditions via a per-column
first-order linear recurrence u[i] = c_i u[i-1] + d_i evaluated with
`associative_scan` (log-depth, vectorised over the pair batch).

Total latency: P + Q − 1 supersteps for P devices × Q column blocks; with
Q ≥ P the pipeline is ≥ 50% utilised and memory per device drops P-fold.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax import shard_map
from jax.sharding import PartitionSpec as P

from gpsig.parallel.mesh import DATA_AXIS


def goursat_tile(inc, top, left, corner):
    """Solve a Goursat tile with given boundaries.

    inc: [..., bs, bt] increments for u-rows r_1..r_bs × u-cols c_1..c_bt;
    top: [..., bt] = u[r_0, c_1..c_bt];  left: [..., bs] = u[r_1..r_bs, c_0];
    corner: [...] = u[r_0, c_0].

    Returns (tile [..., bs, bt], bottom [..., bt]) where tile[i, j] =
    u[r_{i+1}, c_{j+1}] and bottom is its last row.
    """
    bs, bt = inc.shape[-2], inc.shape[-1]
    batch = inc.shape[:-2]

    inc_cols = jnp.moveaxis(inc, -1, 0)  # [bt, ..., bs]
    top_cols = jnp.moveaxis(top, -1, 0)  # [bt, ...]

    def col_step(carry, xs):
        pc, pc_top = carry  # previous column [..., bs], its top scalar [...]
        a, t = xs  # a: [..., bs] increments this column; t: u[r_0, c_j]
        c = 1.0 + 0.5 * a
        pc_shift = jnp.concatenate(
            [pc_top[..., None], pc[..., :-1]], axis=-1
        )
        d = pc * c - pc_shift
        # u[i] = c_i u[i-1] + d_i, u[0-] = t ; prefix-compose (c, d)
        def compose(x, y):
            cx, dx = x
            cy, dy = y
            return cx * cy, cy * dx + dy

        C, Dv = lax.associative_scan(compose, (c, d), axis=-1)
        col = C * t[..., None] + Dv
        return (col, t), col

    (last_col, last_top), cols = lax.scan(
        col_step, (left, corner), (inc_cols, top_cols)
    )
    tile = jnp.moveaxis(cols, 0, -1)  # [..., bs, bt]
    return tile, tile[..., -1, :]


def goursat_corner_seq_sharded(inc, mesh, col_block=None, axis=DATA_AXIS):
    """u(S, T) with the s-axis sharded over ``axis`` of ``mesh``.

    inc: [..., S, T] with S divisible by the axis size. Returns [...].
    """
    Pn = mesh.shape[axis]
    S, T = inc.shape[-2], inc.shape[-1]
    if S % Pn:
        raise ValueError(f"S={S} not divisible by {Pn} devices")
    bs = S // Pn
    bt = col_block or max(1, T // Pn)
    # pad T to a multiple of bt with zero increments (exact no-op)
    Tp = ((T + bt - 1) // bt) * bt
    if Tp != T:
        inc = jnp.pad(
            inc, [(0, 0)] * (inc.ndim - 2) + [(0, 0), (0, Tp - T)]
        )
    Q = Tp // bt
    nsteps = Pn + Q - 1
    batch = inc.shape[:-2]

    def local(inc_blk):
        # inc_blk: [..., bs, Tp] (this device's rows)
        p = lax.axis_index(axis)
        dt = inc_blk.dtype
        ones_bs = jnp.ones(batch + (bs,), dt)
        ones_bt = jnp.ones(batch + (bt,), dt)
        one = jnp.ones(batch, dt)

        def superstep(k, carry):
            left, corner, top_in, bottom_prev, result = carry
            q = k - p  # my column-block index this superstep
            active = (q >= 0) & (q < Q)
            q_safe = jnp.clip(q, 0, Q - 1)
            a_tile = lax.dynamic_slice_in_dim(
                inc_blk, q_safe * bt, bt, axis=-1
            )
            # row-0 devices use the u≡1 boundary; others use the halo.
            top = jnp.where(p == 0, ones_bt, top_in)
            tile, bottom = goursat_tile(a_tile, top, left, corner)
            new_left = jnp.where(active, tile[..., :, -1], left)
            new_corner = jnp.where(active, top[..., -1], corner)
            # u(S,T): last device's tile for the final column block
            is_final = (p == Pn - 1) & (q == Q - 1)
            result = jnp.where(
                is_final & active, tile[..., -1, -1], result
            )
            # ship my bottom row to p+1 (it becomes their top next step)
            send = jnp.where(active, bottom, bottom_prev)
            halo = lax.ppermute(
                send, axis, [(i, i + 1) for i in range(Pn - 1)]
            )
            return new_left, new_corner, halo, send, result

        init = (ones_bs, one, ones_bt, ones_bt, jnp.zeros(batch, dt))
        _, _, _, _, result = lax.fori_loop(
            0, nsteps, superstep, init
        )
        # every device holds 0 except the last; reduce to replicate
        return lax.psum(result, axis)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=P(*([None] * len(batch)), axis, None),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(fn)(inc)
