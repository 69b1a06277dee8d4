"""Multi-chip: sharded SVI, Gram tiling, sequence-parallel PDE, NUTS chains.

The distributed layer the reference never had (SURVEY.md §2.4). By default
this runs on 8 virtual CPU devices (the multi-chip semantics need >= 2
devices, and this machine has one chip); pass --device to use the real
device mesh on an actual multi-chip host:

    python examples/04_multichip.py            # 8 virtual CPU devices
    python examples/04_multichip.py --device   # real device mesh
"""

import sys

sys.path.insert(0, ".")

import numpy as np


def main():
    import os

    if "--device" not in sys.argv:
        os.environ.setdefault(
            "XLA_FLAGS", "--xla_force_host_platform_device_count=8"
        )
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp
    import optax

    from gpsig import SVGP, SignatureRBF, likelihoods
    from gpsig import make_inducing_tensors_from_data
    from gpsig.data.synthetic import classification_sequences
    from gpsig.ops import goursat
    from gpsig.parallel import mesh as meshlib
    from gpsig.parallel.chains import run_chains_sharded
    from gpsig.parallel.goursat_sp import goursat_corner_seq_sharded
    from gpsig.parallel.loader import ShardedLoader
    from gpsig.parallel.train import make_sharded_step_fn, sharded_gram
    from gpsig.training.loop import init_state

    mesh = meshlib.make_mesh()  # all devices on the 'data' axis
    print("mesh:", dict(mesh.shape))

    X, y = classification_sequences(seed=0, N=160, L=16, d=2,
                                    num_classes=2)
    Xj = jnp.asarray(X)

    # 1) data-parallel SVI: psum'd ELBO/natgrad/Adam -------------------------
    kern = SignatureRBF(2, 2, lengthscales=1.0)
    feat = make_inducing_tensors_from_data(
        jax.random.PRNGKey(0), Xj, num_tensors=16, num_levels=2,
        num_features=2,
    )
    model = SVGP.create(kern, likelihoods.MultiClass(2), feat, num_latent=2)
    opt = optax.adam(2e-3)
    step = make_sharded_step_fn(opt, num_data=len(y), mesh=mesh, gamma=0.05)
    state = init_state(model, opt)
    loader = ShardedLoader(mesh, X, y, batch_size=64)
    key = jax.random.PRNGKey(0)
    for it in range(10):
        xb, yb = next(loader)
        key, sub = jax.random.split(key)
        state, elbo = step(state, xb, yb, sub)
    print("sharded SVI ELBO after 10 steps:", float(elbo))

    # 2) Gram tiling over the (data, tile) mesh ------------------------------
    mesh2 = meshlib.make_mesh(data=len(jax.devices()) // 2, tile=2)
    K = sharded_gram(state.model.kernel, mesh2, Xj[:32])
    print("tiled Gram:", K.shape, "finite:", bool(jnp.isfinite(K).all()))

    # 3) sequence-parallel Goursat (context parallelism) ---------------------
    inc = goursat.refine_increments(
        jnp.einsum("nld,nkd->nlk", jnp.diff(Xj[:4], axis=1),
                   jnp.diff(Xj[:4], axis=1)), 0)
    u_sp = goursat_corner_seq_sharded(inc[:, :8, :], mesh)
    u_serial = goursat.goursat_corner(inc[:, :8, :])
    print("seq-sharded PDE max err:",
          float(jnp.max(jnp.abs(u_sp - u_serial))))

    # 4) NUTS chains sharded over devices ------------------------------------
    cov = jnp.asarray([[1.0, 0.6], [0.6, 1.5]])
    prec = jnp.linalg.inv(cov)
    # draws_per_dispatch bounds the transitions per dispatch (host loop
    # over jitted chunks, bit-identical to one big scan) — the checkpoint
    # granularity for long production runs.
    samples, info = run_chains_sharded(
        jax.random.PRNGKey(1), lambda th: -0.5 * th @ prec @ th,
        0.1 * jax.random.normal(jax.random.PRNGKey(2), (8, 2)), mesh,
        num_warmup=150, num_samples=200, max_depth=6,
        draws_per_dispatch=50,
    )
    s = np.asarray(samples).reshape(-1, 2)
    print("NUTS sample cov:\n", np.round(np.cov(s.T), 2))


if __name__ == "__main__":
    main()
