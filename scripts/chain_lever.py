"""Measure the chains-per-device lever on the virtual
8-device CPU mesh.

`lax.while_loop` under vmap runs every chain in a device's block until the
whole block's trees terminate, so a block of B chains executes
B x max(leaves) leapfrogs per transition while only sum(leaves) are useful
— per-draw cost tracks the *deepest* tree in the block. Sharding chains
over more devices with smaller per-device blocks (shard_map) does not pay
this tax across blocks. This script measures that directly, with the same
128 chains and the same signature-GPR posterior:

  1x128   one device, one vmap block of 128 chains
  8x16    eight (virtual) devices, blocks of 16   [the multi-device configuration]
  seq 8x16  eight blocks of 16 run back-to-back on ONE device — isolates
            the block-size effect from host-parallel execution of the
            virtual devices (2 physical cores serve all 8), i.e. the
            per-device work one card would see, summed

and compares the measured walls with the utilization predicted from the
run's own leaf counts (useful/executed leapfrogs per transition —
grouping-independent, so one run predicts every grouping).

CPU-only (virtual devices); on a card, `chip_smoke.py`'s nuts phase
measures one vmap block of chains on one device.
"""

import json
import os
import sys
import time

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from gpsig import params as pr
    from gpsig.data.synthetic import regression_sequences
    from gpsig.kernels.signature import SignatureRBF
    from gpsig.models.gpr import GPR
    from gpsig.parallel import mesh as meshlib
    from gpsig.parallel.chains import make_chunked_sampler

    dtype = jnp.float32
    d, nl, N, L = 2, 3, 24, 12
    C, WARM, SAMP, DEPTH = 128, 30, 30, 6
    X, y = regression_sequences(seed=0, N=N, L=L, d=d)
    Xj, yj = jnp.asarray(X, dtype), jnp.asarray(y, dtype)

    def logp(theta):
        ell = jnp.exp(theta[:d])
        var = jnp.exp(theta[d : d + nl + 1])
        noise = jnp.exp(theta[-1])
        kern = SignatureRBF(d, nl, lengthscales=1.0, order=1,
                            normalization=True, dtype=dtype)
        kern = kern.replace(raw_lengthscales=pr.inv_positive(ell),
                            raw_variances=pr.inv_positive(var))
        m = GPR.create(kern, noise_variance=noise, dtype=dtype)
        return m.log_marginal_likelihood(Xj, yj) - 0.5 * jnp.sum(
            theta**2) / 4.0

    dim = d + nl + 2
    theta0 = 0.1 * jax.random.normal(jax.random.PRNGKey(1), (C, dim),
                                     dtype)
    mesh1 = meshlib.make_mesh(devices=jax.devices()[:1])
    mesh8 = meshlib.make_mesh(data=8, tile=1)
    kw = dict(num_warmup=WARM, num_samples=SAMP, max_depth=DEPTH,
              draws_per_dispatch=max(WARM, SAMP))

    def steady(sampler, key, t0s):
        sampler(jax.random.PRNGKey(0), t0s)  # compile
        t0 = time.time()
        _, info = sampler(key, t0s)
        return time.time() - t0, info

    w1, info1 = steady(make_chunked_sampler(logp, mesh1, **kw),
                       jax.random.PRNGKey(3), theta0)
    w8, info8 = steady(make_chunked_sampler(logp, mesh8, **kw),
                       jax.random.PRNGKey(3), theta0)

    # eight 16-chain blocks back-to-back on one device (one compile,
    # cached chunk fns; different keys per block)
    s16 = make_chunked_sampler(logp, mesh1, **kw)
    s16(jax.random.PRNGKey(0), theta0[:16])  # compile
    t0 = time.time()
    leaves_seq = []
    for i in range(8):
        _, info_i = s16(jax.random.PRNGKey(100 + i),
                        theta0[16 * i : 16 * (i + 1)])
        leaves_seq.append(np.asarray(info_i["num_leaves"]))
    w_seq = time.time() - t0

    def util(leaves, bsz):
        blocks = leaves.reshape(leaves.shape[0] // bsz, bsz, -1)
        useful = blocks.sum(axis=1)
        executed = bsz * blocks.max(axis=1)
        return float((useful / np.maximum(executed, 1)).mean())

    lv1 = np.asarray(info1["num_leaves"], np.float64)
    pred = {f"{C//b}dev_x{b}": round(util(lv1, b), 3)
            for b in (128, 64, 32, 16, 8)}
    report = {
        "shapes": dict(C=C, N=N, L=L, d=d, num_levels=nl, dim=dim,
                       warmup=WARM, samples=SAMP, max_depth=DEPTH),
        "wall_s": {"1dev_x128": round(w1, 1),
                   "8vdev_x16": round(w8, 1),
                   "seq_8_blocks_of_16_1dev": round(w_seq, 1)},
        "draws_per_s": {"1dev_x128": round(C * SAMP / w1, 1),
                        "8vdev_x16": round(C * SAMP / w8, 1),
                        "seq_blocks": round(C * SAMP / w_seq, 1)},
        "measured_block_size_effect_seq_vs_128": round(w1 / w_seq, 2),
        "measured_8vdev_speedup": round(w1 / w8, 2),
        "predicted_utilization_from_1x128_leaves": pred,
        "predicted_speedup_16_vs_128": round(
            pred["8dev_x16"] / pred["1dev_x128"], 2),
        "mean_leaves": {"1x128": float(lv1.mean()),
                        "8x16": float(
                            np.asarray(info8["num_leaves"]).mean()),
                        "seq": float(np.mean(
                            [lv.mean() for lv in leaves_seq]))},
        "note": ("8 virtual devices share 2 physical cores, so "
                 "8vdev_x16 mixes utilization gain with host thread "
                 "parallelism; seq_8_blocks isolates the block-size "
                 "(worst-chain serialization) effect at fixed "
                 "single-stream execution."),
    }
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
