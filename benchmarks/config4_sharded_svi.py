"""BASELINE config 4: large-N sharded minibatch SVI across a device mesh
(InsectWingbeat-shaped; synthetic fallback). On a 1-chip machine, run with
--fake-devices 8 to exercise the sharded path on virtual CPU devices."""

import os
import sys
import time

sys.path.insert(0, ".")


def main():
    # device-count env must be set before importing jax
    if "--fake-devices" in sys.argv:
        i = sys.argv.index("--fake-devices")
        n = sys.argv[i + 1]
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={n}"
        )

    from benchmarks.common import (
        accuracy_and_nlpp,
        base_parser,
        get_classification_data,
        report,
        setup_jax,
    )

    p = base_parser(__doc__)
    p.add_argument("--dataset", default="InsectWingbeat")
    p.add_argument("--fake-devices", type=int, default=0)
    p.add_argument("--num-tensors", type=int, default=64)
    p.add_argument("--batch", type=int, default=256)
    args = p.parse_args()
    if args.fake_devices:
        args.cpu = True
    jax = setup_jax(args)
    import jax.numpy as jnp
    import numpy as np
    import optax

    from gpsig import likelihoods as liks
    from gpsig.inducing import make_inducing_tensors_from_data
    from gpsig.kernels.signature import SignatureRBF
    from gpsig.models.svgp import SVGP
    from gpsig.parallel import mesh as meshlib
    from gpsig.parallel.train import make_sharded_step_fn
    from gpsig.training.loop import init_state

    Xtr, ytr, Xte, yte, name = get_classification_data(
        args.dataset, args.seed,
        synth_kwargs=dict(N=20000, L=30, d=3, num_classes=5),
    )
    dtype = jnp.float64 if args.x64 else jnp.float32
    d = Xtr.shape[-1]
    C = int(max(ytr.max(), yte.max())) + 1
    N = len(ytr)
    Xtr_j = jnp.asarray(Xtr, dtype)

    mesh = meshlib.make_mesh()  # all devices on the data axis
    n_dev = len(jax.devices())
    kern = SignatureRBF(d, 3, lengthscales=1.0, order=1,
                        normalization=True, dtype=dtype)
    feat = make_inducing_tensors_from_data(
        jax.random.PRNGKey(args.seed), Xtr_j[:500],
        num_tensors=args.num_tensors, num_levels=3, num_features=d,
    )
    model = SVGP.create(kern, liks.MultiClass(num_classes=C), feat,
                        num_latent=C, dtype=dtype)
    opt = optax.adam(2e-3)
    step = make_sharded_step_fn(opt, num_data=N, mesh=mesh, gamma=0.05)
    state = init_state(model, opt)

    B = args.batch - (args.batch % n_dev)
    rng = np.random.default_rng(args.seed)
    key = jax.random.PRNGKey(args.seed)
    iters = args.iters or 300
    t0 = None
    for it in range(iters):
        idx = rng.choice(N, B, replace=False)
        xb, yb = meshlib.shard_batch(
            mesh, Xtr_j[idx], jnp.asarray(ytr[idx])
        )
        key, sub = jax.random.split(key)
        state, elbo = step(state, xb, yb, sub)
        if it == 4:
            elbo.block_until_ready()
            t0 = time.time()
    elbo.block_until_ready()
    t_train = time.time() - t0
    steps_per_s = (iters - 5) / t_train
    acc, nlpp = accuracy_and_nlpp(
        state.model, jnp.asarray(Xte[:2000], dtype), yte[:2000]
    )
    report(
        config=4, dataset=name, num_train=N, devices=n_dev,
        batch=B, iters=iters,
        elbo_steps_per_s=round(steps_per_s, 3),
        samples_per_s=round(steps_per_s * B, 1),
        test_acc=acc, test_nlpp=nlpp, final_elbo=float(elbo),
    )


if __name__ == "__main__":
    main()
