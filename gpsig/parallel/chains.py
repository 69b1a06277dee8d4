"""Multi-device NUTS: chains sharded over the mesh's ``data`` axis with
step-size adaptation statistics reduced via collectives (BASELINE config 5).

Each device runs a block of chains (vmap inside shard_map); during warmup
the dual-averaging acceptance statistic is ``pmean``-reduced over *all*
chains on *all* devices, so every chain adapts the same step size — the
cross-device collective rides the interconnect exactly like the SVI psum.

By default each phase (warmup, sampling) is one device dispatch. An
explicit ``draws_per_dispatch`` bounds how many NUTS transitions run inside
one dispatch instead: the host loops over jitted chunks, carrying the full
adaptation state (NUTS state, dual-averaging, Welford mass, keys) between
them, and each chunk boundary is a checkpoint/progress point for long or
preemptible runs. The chunked path is bit-identical
to the monolithic one — ``make_warm_step`` keys the mass-matrix window on
the *absolute* warmup index, and key threading is unchanged — which
``tests/test_nuts.py::test_chunked_dispatch_matches_monolithic`` pins.
Use ``make_chunked_sampler`` directly to reuse the compiled chunk
functions across repeated sampling calls (one trace per chunk size).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax import shard_map
from jax.sharding import PartitionSpec as P

from gpsig.mcmc.nuts import NutsState, nuts_kernel
from gpsig.mcmc.sample import (
    da_init,
    make_samp_step,
    make_warm_step,
    run_nuts,
    welford_init,
)
from gpsig.parallel.mesh import DATA_AXIS


def run_chains_sharded(
    key, logp_fn, theta0s, mesh, num_warmup=500, num_samples=500,
    max_depth=8, target_accept=0.8, init_step_size=0.1,
    shared_step_size=True, draws_per_dispatch=None, chain_blocks=1,
):
    """theta0s: [C, D] with C divisible by the mesh data-axis size.

    draws_per_dispatch: no single device dispatch runs more than this many
    NUTS transitions (host loop over jitted chunks; see module docstring).
    The default ``None`` runs one dispatch per phase — but note that
    ``chain_blocks > 1`` always routes through the chunked sampler (with
    ``draws_per_dispatch = max(num_warmup, num_samples, 1)``, i.e. one
    chunk per phase), since sequential vmap blocks are implemented there.

    chain_blocks: split each device's chains into this many sequential
    vmap blocks (see ``make_chunked_sampler``) — the single-chip
    worst-chain-serialization lever. Values > 1 route through the chunked
    sampler (identical math for independent chains).

    Returns (samples [C, num_samples, D], info pytree)."""
    C = theta0s.shape[0]
    n_dev = mesh.shape[DATA_AXIS]
    if C % n_dev:
        raise ValueError(f"chains {C} not divisible by devices {n_dev}")

    if draws_per_dispatch is not None or chain_blocks != 1:
        sampler = make_chunked_sampler(
            logp_fn, mesh, num_warmup=num_warmup,
            num_samples=num_samples, max_depth=max_depth,
            target_accept=target_accept, init_step_size=init_step_size,
            shared_step_size=shared_step_size,
            draws_per_dispatch=(draws_per_dispatch
                                if draws_per_dispatch is not None
                                else max(num_warmup, num_samples, 1)),
            chain_blocks=chain_blocks,
        )
        return sampler(key, theta0s)

    keys = jax.random.split(key, C)
    reduce = _make_reduce(shared_step_size)

    def local(keys_blk, thetas_blk):
        f = jax.vmap(
            lambda k, t: run_nuts(
                k, logp_fn, t, num_warmup=num_warmup,
                num_samples=num_samples, max_depth=max_depth,
                target_accept=target_accept,
                init_step_size=init_step_size,
                cross_chain_mean=reduce,
            ),
            axis_name="chain",
        )
        return f(keys_blk, thetas_blk)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=P(DATA_AXIS),
        check_vma=False,
    )
    return jax.jit(fn)(keys, theta0s)


def _make_reduce(shared_step_size):
    if not shared_step_size:
        return None

    # mean over local vmap axis happens implicitly by vmapping the
    # *scalar* statistic through pmean: pmean over the mesh axis averages
    # across devices; the in-device chain average is taken by wrapping the
    # vmapped kernel's statistic.
    def reduce(acc):
        acc = lax.pmean(acc, "chain")  # across local chains
        return lax.pmean(acc, DATA_AXIS)  # across devices

    return reduce


def make_chunked_sampler(
    logp_fn, mesh, num_warmup=500, num_samples=500, max_depth=8,
    target_accept=0.8, init_step_size=0.1, shared_step_size=True,
    draws_per_dispatch=100, chain_blocks=1,
):
    """Build ``sample(key, theta0s) -> (samples, info)`` that hosts-loops
    over jitted chunks of at most ``draws_per_dispatch`` NUTS transitions.

    The jitted chunk functions are built once and cached on the returned
    callable, so repeated calls (new keys / new starting points of the
    same shape) reuse the compiled executables — one trace per distinct
    chunk size. Exact key/adaptation threading of ``run_nuts``
    (mcmc/sample.py), so results are bit-identical to the monolithic
    dispatch.

    chain_blocks: run each device's local chains as this many *sequential*
    vmap blocks (``lax.map`` over groups) instead of one vmap block.
    ``lax.while_loop`` under vmap serializes a block on its deepest tree
    each transition, so per-transition wall tracks max(leaves) over the
    block; smaller blocks waste fewer leapfrogs (measured on the virtual
    mesh: 8 blocks of 16 = 1.43x the draws/s of one block of 128 at fixed
    single-stream execution; ``scripts/chain_lever.py`` re-measures it).
    Per-chain math is unchanged (independent chains: results are
    bit-identical for any grouping); with ``shared_step_size`` the
    dual-averaging statistic pools within (block, mesh-axis) — i.e.
    ``chain_blocks`` step-size groups per device set instead of one —
    exactly what sharding the same chains over more devices does."""
    blk_max = int(draws_per_dispatch)
    chain_blocks = int(chain_blocks)
    kernel = nuts_kernel(logp_fn, max_depth=max_depth)
    mass_start = int(0.1 * num_warmup)
    mass_end = int(0.9 * num_warmup)
    reduce = _make_reduce(shared_step_size)
    warm_step = make_warm_step(kernel, target_accept, mass_start,
                               mass_end, reduce)
    samp_step = make_samp_step(kernel)
    spec = P(DATA_AXIS)

    @jax.jit
    def init(keys, thetas):
        def one(k, t):
            logp0, grad0 = jax.value_and_grad(logp_fn)(t)
            k_samp, kw = jax.random.split(k)  # run_nuts: key, kw = split
            carry = (NutsState(t, logp0, grad0),
                     da_init(jnp.asarray(init_step_size, t.dtype)),
                     welford_init(t.shape[0], t.dtype),
                     jnp.ones(t.shape, t.dtype), kw)
            return carry, k_samp

        f = shard_map(jax.vmap(one), mesh=mesh, in_specs=(spec, spec),
                      out_specs=(spec, spec), check_vma=False)
        return f(keys, thetas)

    def _blocked(vf):
        """Run a per-device vmapped chain fn as ``chain_blocks``
        sequential vmap blocks (lax.map over groups); grouping leaves
        independent-chain math untouched, only the while-loop
        synchronization set (and the vmap-axis pmean) shrinks."""
        if chain_blocks == 1:
            return vf

        def blocked(carry):
            grouped = jax.tree.map(
                lambda x: x.reshape(
                    (chain_blocks, x.shape[0] // chain_blocks)
                    + x.shape[1:]),
                carry,
            )
            out = lax.map(vf, grouped)
            return jax.tree.map(
                lambda x: x.reshape((-1,) + x.shape[2:]), out)

        return blocked

    def make_warm_fn(blk):
        def local(carry, t0):
            f = jax.vmap(
                lambda c: lax.scan(warm_step, c, t0 + jnp.arange(blk)),
                axis_name="chain",
            )
            return _blocked(f)(carry)

        return jax.jit(shard_map(
            local, mesh=mesh, in_specs=(spec, P()),
            out_specs=(spec, spec), check_vma=False,
        ))

    def make_samp_fn(blk):
        def local(carry):
            f = jax.vmap(
                lambda c: lax.scan(samp_step, c, None, length=blk),
                axis_name="chain",
            )
            return _blocked(f)(carry)

        return jax.jit(shard_map(
            local, mesh=mesh, in_specs=(spec,), out_specs=(spec, spec),
            check_vma=False,
        ))

    fns = {}

    def _config(num_chains):
        """Sampler settings a checkpoint must match to be resumable
        (advisor r3: resuming under different settings silently mixes
        incompatible adaptation state, e.g. a shifted mass-matrix
        window)."""
        return {
            "num_warmup": int(num_warmup),
            "num_samples": int(num_samples),
            "num_chains": int(num_chains),
            "max_depth": int(max_depth),
            "target_accept_milli": int(round(1000 * target_accept)),
            "draws_per_dispatch": blk_max,
            "chain_blocks": chain_blocks,
        }

    def _pack(phase, pos, chunk, warm_carry, samp_carry, samp_keys, bufs,
              num_chains):
        tree = {"phase": np.int64(phase), "pos": np.int64(pos),
                "chunk": np.int64(chunk), "samp_keys": samp_keys,
                "bufs": bufs,
                "config": {k: np.int64(v)
                           for k, v in _config(num_chains).items()}}
        if phase == 0:
            st, da, wf, im, k = warm_carry
            tree["warm"] = {"state": st._asdict(), "da": da._asdict(),
                            "wf": wf._asdict(), "inv_mass": im, "key": k}
        else:
            st, ks, eps, im = samp_carry
            tree["samp"] = {"state": st._asdict(), "keys": ks, "eps": eps,
                            "inv_mass": im}
        return tree

    def _unpack(tree):
        from gpsig.mcmc.sample import DAState, WelfordState

        phase = int(tree["phase"])
        warm_carry = samp_carry = None
        if phase == 0:
            w = tree["warm"]
            warm_carry = (NutsState(**w["state"]), DAState(**w["da"]),
                          WelfordState(**w["wf"]), w["inv_mass"],
                          w["key"])
        else:
            s = tree["samp"]
            samp_carry = (NutsState(**s["state"]), s["keys"], s["eps"],
                          s["inv_mass"])
        bufs = {k: np.asarray(v) for k, v in tree["bufs"].items()}
        return (phase, int(tree["pos"]), int(tree["chunk"]), warm_carry,
                samp_carry, tree["samp_keys"], bufs)

    def _load_latest(cdir, expect_config):
        import os

        from gpsig.utils.checkpoint import restore_checkpoint

        if not os.path.isdir(cdir):
            return None
        steps = sorted(
            (d for d in os.listdir(cdir) if d.startswith("chunk_")),
            reverse=True)
        errors = []
        for d in steps:
            try:
                tree = restore_checkpoint(os.path.join(cdir, d), None)
            except Exception as e:  # incomplete save — try the previous
                errors.append((d, e))
                continue
            saved = {k: int(v) for k, v in tree.get("config", {}).items()}
            # Checkpoints written before chain_blocks existed carry no such
            # key; chain_blocks=1 is bit-identical to the old behavior, so
            # default it rather than rejecting legacy checkpoints.
            if saved:
                saved.setdefault("chain_blocks", 1)
            if saved and saved != expect_config:
                raise ValueError(
                    f"checkpoint {cdir}/{d} was written under a different "
                    f"sampler config {saved} (this sampler: "
                    f"{expect_config}); resuming would silently mix "
                    "incompatible adaptation state. Point checkpoint_dir "
                    "elsewhere or rebuild the sampler with the original "
                    "settings."
                )
            return _unpack(tree)
        if errors:
            # Checkpoints exist but none restored: starting fresh would
            # silently discard (and then delete) a long run's state.
            raise RuntimeError(
                f"{len(errors)} checkpoint(s) in {cdir} exist but none "
                f"could be restored (last error on {errors[0][0]}: "
                f"{errors[0][1]!r}). Refusing to silently restart from "
                "scratch — move/delete the directory to start fresh."
            )
        return None

    def _save(cdir, chunk, tree):
        import os
        import shutil

        from gpsig.utils.checkpoint import save_checkpoint

        path = os.path.join(cdir, f"chunk_{chunk:06d}")
        save_checkpoint(path, tree)
        for d in os.listdir(cdir):  # retain only the save that just landed
            if d.startswith("chunk_") and d != f"chunk_{chunk:06d}":
                shutil.rmtree(os.path.join(cdir, d), ignore_errors=True)

    def sample(key, theta0s, checkpoint_dir=None, max_chunks=None,
               on_chunk=None):
        """Run (or resume) the chunked sampler.

        checkpoint_dir: if set, the full sampler state (NUTS state,
        adaptation, keys, accumulated draws) is persisted after every
        chunk and a later call with the same directory resumes from the
        last completed chunk — ``key``/``theta0s`` are ignored on resume
        beyond shape checking. max_chunks: process at most this many
        chunks in this call and return ``None`` if unfinished (state is
        on disk) — the time-budgeted slice API for preemptible jobs.
        Checkpointing never perturbs the draw stream (pinned by
        ``test_nuts.py::test_checkpoint_resume_matches_uninterrupted``).
        on_chunk: optional ``fn(phase: str, pos: int, total: int)`` called
        on the host after every completed (and materialized) chunk with
        phase ``"warmup"`` or ``"sampling"`` — progress reporting / wall
        timing for long runs where a chunk is the dispatch unit.
        """
        C = theta0s.shape[0]
        n_dev = mesh.shape[DATA_AXIS]
        if C % n_dev:
            raise ValueError(
                f"chains {C} not divisible by devices {n_dev}")
        if (C // n_dev) % chain_blocks:
            raise ValueError(
                f"per-device chains {C // n_dev} not divisible by "
                f"chain_blocks {chain_blocks}")
        if max_chunks is not None and checkpoint_dir is None:
            raise ValueError(
                "max_chunks without checkpoint_dir would return None with "
                "all progress discarded (state lives only in local "
                "variables) — pass checkpoint_dir so the slice persists."
            )
        resumed = (
            _load_latest(checkpoint_dir, _config(C))
            if checkpoint_dir else None
        )
        if resumed is None:
            keys = jax.random.split(key, C)
            carry, samp_keys = init(keys, theta0s)
            phase, pos, chunk, samp_carry, bufs = 0, 0, 0, None, {}
        else:
            phase, pos, chunk, carry, samp_carry, samp_keys, bufs = resumed
        done_here = 0

        def checkpoint():
            if checkpoint_dir:
                _save(checkpoint_dir, chunk,
                      _pack(phase, pos, chunk, carry, samp_carry,
                            samp_keys, bufs, C))

        while phase == 0:
            if pos >= num_warmup:
                state, da, _, inv_mass, _ = carry
                samp_carry = (state, samp_keys,
                              jnp.exp(da.log_eps_bar), inv_mass)
                phase, pos = 1, 0
                break
            if max_chunks is not None and done_here >= max_chunks:
                return None
            blk = min(blk_max, num_warmup - pos)
            fn = fns.setdefault(("w", blk), make_warm_fn(blk))
            carry, acc = fn(carry, jnp.int32(pos))
            acc = np.asarray(acc)
            bufs.setdefault(
                "warmup_accept", np.zeros((C, num_warmup), acc.dtype)
            )[:, pos:pos + blk] = acc
            pos += blk
            chunk += 1
            done_here += 1
            checkpoint()
            if on_chunk is not None:
                on_chunk("warmup", pos, num_warmup)

        while pos < num_samples:
            if max_chunks is not None and done_here >= max_chunks:
                checkpoint()  # persists the warm→samp transition too
                return None
            blk = min(blk_max, num_samples - pos)
            fn = fns.setdefault(("s", blk), make_samp_fn(blk))
            samp_carry, out = fn(samp_carry)
            out = {k: np.asarray(v) for k, v in out.items()}
            for k, v in out.items():
                bufs.setdefault(k, np.zeros(
                    (C, num_samples) + v.shape[2:], v.dtype
                ))[:, pos:pos + blk] = v
            pos += blk
            chunk += 1
            done_here += 1
            checkpoint()
            if on_chunk is not None:
                on_chunk("sampling", pos, num_samples)

        eps, inv_mass = samp_carry[2], samp_carry[3]
        dt = np.asarray(theta0s).dtype
        D = theta0s.shape[1]
        # num_samples=0 never enters the sampling loop: fall back to
        # correctly-shaped empty buffers so the chunked path matches the
        # monolithic run_chains_sharded's empty draw arrays (advisor r3).
        info = {
            "step_size": eps,
            "inv_mass": inv_mass,
            "warmup_accept": bufs.get(
                "warmup_accept", np.zeros((C, 0), dt)),
            "accept_prob": bufs.get("accept_prob",
                                    np.zeros((C, num_samples), dt)),
            "diverging": bufs.get("diverging",
                                  np.zeros((C, num_samples), bool)),
            "num_leaves": bufs.get("num_leaves",
                                   np.zeros((C, num_samples), np.int32)),
            "logp": bufs.get("logp", np.zeros((C, num_samples), dt)),
        }
        return bufs.get("theta", np.zeros((C, num_samples, D), dt)), info

    return sample
