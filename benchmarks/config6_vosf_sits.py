"""VOSF at scale: SITS-like classification with orthogonal signature
features (Kuu = I), N >= 100k sequences — the fork's headline scaling
capability (SURVEY.md §2.2 VOSF row; the ~1M-series SITS experiment of
Lemercier et al., ICML 2021).

One GP per class, diagonal q, O(M) KL/natgrad — every per-step cost is
linear in the number of features, so throughput is dispatch/feature-bound,
not chol-bound. Reports samples/s (steady state) and a device-memory
account.
"""

import sys
import time

sys.path.insert(0, ".")

import numpy as np

from benchmarks.common import accuracy_and_nlpp, base_parser, report, setup_jax


def main():
    p = base_parser(__doc__)
    p.add_argument("--num-train", type=int, default=120_000)
    p.add_argument("--num-test", type=int, default=10_000)
    p.add_argument("--seq-len", type=int, default=40)
    p.add_argument("--classes", type=int, default=10)
    p.add_argument("--num-levels", type=int, default=7,
                   help="signature truncation; M = 2^(nl+1)-2 features at "
                        "d=2 (value + time)")
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--gamma", type=float, default=0.0,
                   help="natgrad step size; 0 = Adam-only (default: the "
                        "stochastic natural gradient is noisy for the "
                        "non-conjugate RobustMax likelihood and small "
                        "gammas just slow Adam down here)")
    args = p.parse_args()
    jax = setup_jax(args)
    import jax.numpy as jnp

    from gpsig import likelihoods as liks
    from gpsig.data import preprocessing as prep
    from gpsig.data.synthetic import sits_sequences
    from gpsig.kernels.vosf import (
        ExplicitSignatureKernel,
        OrthogonalSignatureFeatures,
    )
    from gpsig.models.svgp import SVGP
    from gpsig.ops.explicit import signature_dim
    from gpsig.training.loop import fit

    dtype = jnp.float64 if args.x64 else jnp.float32
    N = args.num_train + args.num_test
    X, y = sits_sequences(seed=args.seed, N=N, L=args.seq_len,
                          num_classes=args.classes)
    X = prep.add_time_to_table(X)  # d = 2
    Xtr, ytr = X[: args.num_train], y[: args.num_train]
    Xte, yte = X[args.num_train:], y[args.num_train:]
    d, nl, C = X.shape[-1], args.num_levels, args.classes
    M = signature_dim(d, nl, include_constant=True)

    kern = ExplicitSignatureKernel.create(d, nl, lengthscales=1.0,
                                          normalization=True, dtype=dtype)
    feat = OrthogonalSignatureFeatures.for_kernel(kern)
    model = SVGP.create(kern, liks.MultiClass(num_classes=C), feat,
                        num_latent=C, q_diag=True, dtype=dtype)

    Xtr_j = jnp.asarray(Xtr, dtype)
    ytr_j = jnp.asarray(ytr)
    iters = args.iters or 1000
    t0 = time.time()
    model, hist = fit(model, Xtr_j, ytr_j, num_iters=iters,
                      batch_size=args.batch, learning_rate=5e-3,
                      gamma=args.gamma, use_natgrad=args.gamma > 0,
                      seed=args.seed, log_every=200)
    t_train = time.time() - t0

    # steady-state timing: re-run a timed chunk on the compiled step
    import optax

    from gpsig.training.loop import init_state, make_step_fn

    step_fn = make_step_fn(optax.adam(5e-3), num_data=args.num_train,
                           gamma=max(args.gamma, 0.1),
                           use_natgrad=args.gamma > 0)
    state = init_state(model, optax.adam(5e-3))
    rng = np.random.default_rng(1)
    key = jax.random.PRNGKey(1)
    idx = rng.choice(args.num_train, args.batch, replace=False)
    state, e = step_fn(state, Xtr_j[idx], ytr_j[idx], key)
    jax.block_until_ready(e)
    R = 30
    t1 = time.time()
    for i in range(R):
        idx = rng.choice(args.num_train, args.batch, replace=False)
        key, sub = jax.random.split(key)
        state, e = step_fn(state, Xtr_j[idx], ytr_j[idx], sub)
    jax.block_until_ready(e)
    dt = time.time() - t1

    mem = None
    try:
        stats = jax.local_devices()[0].memory_stats()
        mem = {k: int(v) for k, v in stats.items()
               if "bytes_in_use" in k or "peak" in k}
    except Exception:
        pass

    # accuracy on a manageable test slice
    acc, nlpp = accuracy_and_nlpp(
        model, jnp.asarray(Xte[:5000], dtype), yte[:5000]
    )
    report(
        config=6, dataset="synthetic-SITS", num_train=args.num_train,
        num_features=M, num_classes=C, batch=args.batch, iters=iters,
        train_time_s=round(t_train, 2),
        steady_steps_per_s=round(R / dt, 2),
        steady_samples_per_s=round(R * args.batch / dt, 1),
        test_acc=acc, test_nlpp=nlpp, final_elbo=hist[-1][1],
        device_memory=mem,
    )


if __name__ == "__main__":
    main()
