"""BASELINE config 5: NUTS over signature-kernel hyperparameters, chains
sharded over the mesh (128 chains multi-host in the full config; scaled by
--chains here). Full-Bayes GP regression: p(θ | y) ∝ p(y | θ) p(θ) with
θ = (log-lengthscales, log-variances, log-noise)."""

import os
import sys
import time

sys.path.insert(0, ".")


def main():
    if "--fake-devices" in sys.argv:
        i = sys.argv.index("--fake-devices")
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={sys.argv[i+1]}"
        )

    from benchmarks.common import base_parser, report, setup_jax

    p = base_parser(__doc__)
    p.add_argument("--fake-devices", type=int, default=0)
    p.add_argument("--chains", type=int, default=16)
    p.add_argument("--warmup", type=int, default=200)
    p.add_argument("--samples", type=int, default=200)
    p.add_argument("--n", type=int, default=40)
    p.add_argument("--l", type=int, default=20, help="sequence length")
    p.add_argument("--levels", type=int, default=3)
    p.add_argument("--engine", default="auto",
                   choices=["auto", "xla", "pallas"],
                   help="signature-Gram engine inside the NUTS logp; "
                        "'pallas' forces the fused Triton Gram kernel, "
                        "'xla' the plain path")
    p.add_argument("--draws-per-dispatch", type=int, default=None,
                   help="bound NUTS transitions per device dispatch (host "
                        "loop over jitted chunks, bit-identical; a "
                        "checkpoint/progress point for long runs)")
    p.add_argument("--chain-blocks", type=int, default=1,
                   help="run each device's chains as this many sequential "
                        "vmap blocks: smaller blocks serialize on a "
                        "shallower worst tree per transition "
                        "(scripts/chain_lever.py measures the lever)")
    args = p.parse_args()
    if args.fake_devices:
        args.cpu = True
    jax = setup_jax(args)
    import jax.numpy as jnp
    import numpy as np

    from gpsig.data.synthetic import regression_sequences
    from gpsig.kernels.signature import SignatureRBF
    from gpsig.models.gpr import GPR
    from gpsig.parallel import mesh as meshlib
    from gpsig.parallel.chains import run_chains_sharded

    dtype = jnp.float64 if args.x64 else jnp.float32
    X, y = regression_sequences(seed=args.seed, N=args.n, L=args.l, d=2)
    Xj, yj = jnp.asarray(X, dtype), jnp.asarray(y, dtype)
    d = 2
    nl = args.levels

    def build(theta):
        # θ: [d] log-lengthscales, [nl+1] log-variances, [1] log-noise
        ell = jnp.exp(theta[:d])
        var = jnp.exp(theta[d : d + nl + 1])
        noise = jnp.exp(theta[-1])
        kern = SignatureRBF(d, nl, lengthscales=1.0, order=1,
                            normalization=True, dtype=dtype,
                            engine=args.engine)
        from gpsig import params as pr

        kern = kern.replace(
            raw_lengthscales=pr.inv_positive(ell),
            raw_variances=pr.inv_positive(var),
        )
        return GPR.create(kern, noise_variance=noise, dtype=dtype)

    def logp(theta):
        m = build(theta)
        lml = m.log_marginal_likelihood(Xj, yj)
        prior = -0.5 * jnp.sum(theta**2) / 4.0  # N(0, 2²) on log-params
        return lml + prior

    dim = d + nl + 2
    mesh = meshlib.make_mesh()
    n_dev = len(jax.devices())
    C = args.chains - (args.chains % n_dev) or n_dev
    theta0 = 0.1 * jax.random.normal(jax.random.PRNGKey(1), (C, dim), dtype)
    t0 = time.time()
    samples, info = run_chains_sharded(
        jax.random.PRNGKey(args.seed), logp, theta0, mesh,
        num_warmup=args.warmup, num_samples=args.samples, max_depth=6,
        draws_per_dispatch=args.draws_per_dispatch,
        chain_blocks=args.chain_blocks,
    )
    jax.block_until_ready(samples)
    t_total = time.time() - t0
    s = np.asarray(samples)
    # simple split-chain R-hat on each coordinate
    half = args.samples // 2
    chains = s.reshape(C, args.samples, dim)
    splits = np.concatenate(
        [chains[:, :half], chains[:, half : 2 * half]], axis=0
    )
    W = splits.var(axis=1, ddof=1).mean(0)
    mu = splits.mean(axis=1)
    Bv = half * mu.var(axis=0, ddof=1)
    rhat = np.sqrt((W * (half - 1) / half + Bv / half) / W)

    # Chains-per-device lever (VERDICT r3 #3): `lax.while_loop` under vmap
    # runs every chain in a device's block until the whole block's trees
    # terminate, so a block's executed leapfrogs per transition is
    # |block| x max(leaves) while only sum(leaves) are useful. The
    # utilization of any hypothetical (devices x chains-per-device)
    # grouping is computable from THIS run's recorded leaf counts — no
    # second run needed (leaf counts are grouping-independent).
    leaves = np.asarray(info["num_leaves"], dtype=np.float64)  # [C, S]
    vmap_util = {}
    bsz = 1
    while bsz <= C:
        blocks = leaves.reshape(C // bsz, bsz, -1)
        useful = blocks.sum(axis=1)
        executed = bsz * blocks.max(axis=1)
        vmap_util[f"{C // bsz}dev_x{bsz}chains"] = round(
            float((useful / np.maximum(executed, 1)).mean()), 3)
        bsz *= 2

    report(
        config=5, chains=C, devices=n_dev, dim=dim,
        warmup=args.warmup, samples=args.samples,
        total_time_s=round(t_total, 2),
        samples_per_s=round(C * args.samples / t_total, 2),
        mean_accept=float(np.mean(np.asarray(info["accept_prob"]))),
        divergence_frac=float(np.mean(np.asarray(info["diverging"]))),
        max_rhat=float(rhat.max()),
        mean_leaves=float(leaves.mean()),
        vmap_block_utilization=vmap_util,
        engine=args.engine,
        chain_blocks=args.chain_blocks,
        posterior_mean_lengthscales=np.exp(
            s.reshape(-1, dim)[:, :d].mean(0)
        ).tolist(),
    )


if __name__ == "__main__":
    main()
