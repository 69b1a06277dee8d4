"""Sparse variational classification of sequences with inducing tensors.

The reference's flagship workflow (SURVEY.md §3.1): SignatureRBF kernel +
InducingTensors + MultiClass likelihood, trained with alternating natural
gradients (variational parameters) and Adam (hyperparameters), then test
accuracy/NLPP — plus checkpoint save/restore.

Run: python examples/02_svgp_classification.py
"""

import sys

sys.path.insert(0, ".")

import numpy as np

import jax

import os
if not os.environ.get("GPSIG_EXAMPLE_DEVICE"):
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

from gpsig import SVGP, SignatureRBF, likelihoods
from gpsig import make_inducing_tensors_from_data
from gpsig.data import preprocessing as prep
from gpsig.data.synthetic import (
    classification_sequences,
    train_test_split,
)
from gpsig.training.loop import fit


def main():
    X, y = classification_sequences(seed=0, N=240, L=30, d=2,
                                    num_classes=3)
    Xtr, ytr, Xte, yte = train_test_split(X, y, 0.25, seed=0)
    scaler = prep.SequenceScaler().fit(Xtr)
    Xtr = prep.add_time_to_table(scaler.transform(Xtr))
    Xte = prep.add_time_to_table(scaler.transform(Xte))
    d, C = Xtr.shape[-1], 3

    kern = SignatureRBF(d, num_levels=3, lengthscales=1.0, order=1,
                        normalization=True)
    # inducing tensors: rank-1 tensor-algebra elements, factors initialised
    # from data increments; increments=True uses RKHS-increment factors.
    feat = make_inducing_tensors_from_data(
        jax.random.PRNGKey(0), jnp.asarray(Xtr), num_tensors=48,
        num_levels=3, num_features=d, increments=True, learn_weights=True,
    )
    model = SVGP.create(kern, likelihoods.MultiClass(num_classes=C), feat,
                        num_latent=C)

    model, history = fit(
        model, jnp.asarray(Xtr), jnp.asarray(ytr),
        num_iters=300, batch_size=64, learning_rate=3e-3, gamma=0.05,
        log_every=50,
    )
    for it, elbo in history:
        print(f"iter {it:4d}  ELBO {elbo:10.2f}")

    p, _ = model.predict_y(jnp.asarray(Xte))
    acc = float((np.asarray(p).argmax(1) == yte).mean())
    nlpp = float(-np.mean(np.log(
        np.asarray(p)[np.arange(len(yte)), yte] + 1e-12)))
    print(f"test accuracy {acc:.3f}   NLPP {nlpp:.3f}")

    # checkpoint round trip
    import optax

    from gpsig.training.loop import init_state
    from gpsig.utils.checkpoint import restore_checkpoint, save_checkpoint

    state = init_state(model, optax.adam(1e-3))
    save_checkpoint("/tmp/gpsig_example_ckpt", state)
    restored = restore_checkpoint("/tmp/gpsig_example_ckpt", state)
    print("checkpoint restored; q_mu equal:",
          bool(jnp.allclose(restored.model.q_mu, model.q_mu)))


if __name__ == "__main__":
    main()
