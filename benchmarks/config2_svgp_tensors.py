"""BASELINE config 2: SVGP classification with inducing tensors,
order-3 signatures (GunPoint-shaped; synthetic fallback when no UEA data)."""

import sys
import time

sys.path.insert(0, ".")

import numpy as np

from benchmarks.common import (
    accuracy_and_nlpp,
    base_parser,
    get_classification_data,
    report,
    setup_jax,
)


def main():
    p = base_parser(__doc__)
    p.add_argument("--dataset", default="GunPoint")
    p.add_argument("--num-tensors", type=int, default=64)
    p.add_argument("--batch", type=int, default=50)
    p.add_argument("--num-levels", type=int, default=3)
    p.add_argument("--classes", type=int, default=2,
                   help="classes for the synthetic fallback dataset")
    p.add_argument("--synth-n", type=int, default=300,
                   help="N for the synthetic fallback dataset")
    p.add_argument("--early-stop", action="store_true",
                   help="hold out 20%% of train for val-accuracy early "
                        "stopping (the reference benchmarks' protocol)")
    args = p.parse_args()
    jax = setup_jax(args)
    import jax.numpy as jnp

    from gpsig import likelihoods as liks
    from gpsig.inducing import make_inducing_tensors_from_data
    from gpsig.kernels.signature import SignatureRBF
    from gpsig.models.svgp import SVGP
    from gpsig.training.loop import fit

    Xtr, ytr, Xte, yte, name = get_classification_data(
        args.dataset, args.seed,
        synth_kwargs=dict(N=args.synth_n, L=50, d=1,
                          num_classes=args.classes),
    )
    dtype = jnp.float64 if args.x64 else jnp.float32
    d = Xtr.shape[-1]
    C = int(max(ytr.max(), yte.max())) + 1
    nl = args.num_levels
    Xtr_j = jnp.asarray(Xtr, dtype)
    val = None
    if args.early_stop:
        nv = max(1, len(ytr) // 5)
        val = (Xtr_j[:nv], jnp.asarray(ytr[:nv]))
        Xtr_j, ytr = Xtr_j[nv:], ytr[nv:]

    kern = SignatureRBF(d, nl, lengthscales=1.0, order=1,
                        normalization=True, dtype=dtype)
    feat = make_inducing_tensors_from_data(
        jax.random.PRNGKey(args.seed), Xtr_j, num_tensors=args.num_tensors,
        num_levels=nl, num_features=d, increments=True,
    )
    model = SVGP.create(kern, liks.MultiClass(num_classes=C), feat,
                        num_latent=C, dtype=dtype)
    t0 = time.time()
    iters = args.iters or 500
    model, hist = fit(
        model, Xtr_j, jnp.asarray(ytr), num_iters=iters,
        batch_size=min(args.batch, len(ytr)), learning_rate=2e-3,
        gamma=0.05, seed=args.seed, val_data=val,
    )
    t_train = time.time() - t0
    acc, nlpp = accuracy_and_nlpp(model, jnp.asarray(Xte, dtype), yte)
    report(
        config=2, dataset=name, num_train=len(ytr), num_test=len(yte),
        num_tensors=args.num_tensors, iters=iters,
        train_time_s=round(t_train, 2),
        steps_per_s=round(iters / t_train, 3),
        test_acc=acc, test_nlpp=nlpp,
        final_elbo=hist[-1][1],
    )


if __name__ == "__main__":
    main()
