"""BASELINE config 1: synthetic 2-D sequences (N=200, len=50) —
signature-kernel Gram matrix + exact GP regression."""

import sys
import time

sys.path.insert(0, ".")

import numpy as np

from benchmarks.common import base_parser, report, setup_jax


def main():
    args = base_parser(__doc__).parse_args()
    jax = setup_jax(args)
    import jax.numpy as jnp

    from gpsig.data.synthetic import regression_sequences
    from gpsig.kernels.signature import SignatureRBF
    from gpsig.models.gpr import GPR

    dtype = jnp.float64 if args.x64 else jnp.float32
    X, y = regression_sequences(seed=args.seed, N=200, L=50, d=2)
    ntr = 150
    Xtr, ytr = jnp.asarray(X[:ntr], dtype), jnp.asarray(y[:ntr], dtype)
    Xte, yte = jnp.asarray(X[ntr:], dtype), jnp.asarray(y[ntr:], dtype)

    kern = SignatureRBF(2, 4, lengthscales=1.0, order=1, normalization=True,
                        dtype=dtype)
    gram = jax.jit(lambda k, x: k.K(x))
    K = gram(kern, Xtr)
    K.block_until_ready()
    t0 = time.time()
    K = gram(kern, Xtr)
    K.block_until_ready()
    t_gram = time.time() - t0

    model = GPR.create(kern, noise_variance=0.05, dtype=dtype)

    # type-II MLE on hypers via Adam
    import optax

    opt = optax.adam(5e-2)

    @jax.jit
    def step(m, s):
        loss, g = jax.value_and_grad(
            lambda mm: -mm.log_marginal_likelihood(Xtr, ytr)
        )(m)
        up, s = opt.update(g, s, m)
        return optax.apply_updates(m, up), s, -loss

    state = opt.init(model)
    iters = args.iters or 60
    for it in range(iters):
        model, state, lml = step(model, state)
    mean, var = model.predict_y(Xtr, ytr, Xte)
    rmse = float(jnp.sqrt(jnp.mean((mean - yte) ** 2)))
    base_rmse = float(jnp.sqrt(jnp.mean((yte - ytr.mean()) ** 2)))
    nlpp = float(
        -jnp.mean(
            -0.5 * jnp.log(2 * np.pi * var)
            - 0.5 * (yte - mean) ** 2 / var
        )
    )
    report(
        config=1,
        gram_time_s=round(t_gram, 4),
        gram_entries_per_s=round(ntr * ntr / t_gram, 1),
        final_lml=float(lml),
        test_rmse=rmse,
        baseline_rmse=base_rmse,
        test_nlpp=nlpp,
    )
    assert rmse < 0.6 * base_rmse, "GPR failed to beat mean predictor"


if __name__ == "__main__":
    main()
