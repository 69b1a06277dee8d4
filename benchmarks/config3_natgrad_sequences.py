"""BASELINE config 3: multivariate classification with inducing sequences +
alternating natural-gradient/Adam (PenDigits-shaped; synthetic fallback)."""

import sys
import time

sys.path.insert(0, ".")

from benchmarks.common import (
    accuracy_and_nlpp,
    base_parser,
    get_classification_data,
    report,
    setup_jax,
)


def main():
    p = base_parser(__doc__)
    p.add_argument("--dataset", default="PenDigits")
    p.add_argument("--num-inducing", type=int, default=40)
    p.add_argument("--inducing-len", type=int, default=8)
    p.add_argument("--batch", type=int, default=50)
    p.add_argument("--early-stop", action="store_true",
                   help="hold out 20%% of train for val-accuracy early "
                        "stopping (the reference benchmarks' protocol)")
    args = p.parse_args()
    jax = setup_jax(args)
    import jax.numpy as jnp

    from gpsig import likelihoods as liks
    from gpsig.inducing import make_inducing_sequences_from_data
    from gpsig.kernels.signature import SignatureRBF
    from gpsig.models.svgp import SVGP
    from gpsig.training.loop import fit

    Xtr, ytr, Xte, yte, name = get_classification_data(
        args.dataset, args.seed,
        synth_kwargs=dict(N=500, L=30, d=3, num_classes=4),
    )
    dtype = jnp.float64 if args.x64 else jnp.float32
    d = Xtr.shape[-1]
    C = int(max(ytr.max(), yte.max())) + 1
    Xtr_j = jnp.asarray(Xtr, dtype)
    val = None
    if args.early_stop:
        nv = max(1, len(ytr) // 5)
        val = (Xtr_j[:nv], jnp.asarray(ytr[:nv]))
        Xtr_j, ytr = Xtr_j[nv:], ytr[nv:]

    kern = SignatureRBF(d, 4, lengthscales=1.0, order=1,
                        normalization=True, dtype=dtype)
    feat = make_inducing_sequences_from_data(
        jax.random.PRNGKey(args.seed), Xtr_j,
        num_inducing=args.num_inducing, length=args.inducing_len,
        num_features=d,
    )
    model = SVGP.create(kern, liks.MultiClass(num_classes=C), feat,
                        num_latent=C, dtype=dtype)
    iters = args.iters or 400
    t0 = time.time()
    model, hist = fit(
        model, Xtr_j, jnp.asarray(ytr), num_iters=iters,
        batch_size=min(args.batch, len(ytr)), learning_rate=2e-3,
        gamma=0.1, use_natgrad=True, seed=args.seed, val_data=val,
    )
    t_train = time.time() - t0
    acc, nlpp = accuracy_and_nlpp(model, jnp.asarray(Xte, dtype), yte)
    report(
        config=3, dataset=name, num_train=len(ytr),
        num_inducing=args.num_inducing, iters=iters,
        train_time_s=round(t_train, 2),
        steps_per_s=round(iters / t_train, 3),
        test_acc=acc, test_nlpp=nlpp, final_elbo=hist[-1][1],
    )


if __name__ == "__main__":
    main()
