"""Migrating a reference (GPSig / GPflow 1.x) script to gpsig.compat.

The compat package mirrors the reference's module layout and call
conventions (SURVEY.md §2.1: ``gpsig.kernels`` / ``inducing_variables`` /
``models`` / ``preprocessing`` + GPflow optimizers), so a reference
user's workflow carries over line-for-line: flattened ``[N, L*d]``
inputs, ``input_dim``-first kernel constructors, a data-holding ``SVGP``
with ``minibatch_size``, alternating ``NatGradOptimizer`` +
``AdamOptimizer`` steps, numpy in/out everywhere.

Run: python examples/05_gpsig_compat.py
"""

import os
import sys

sys.path.insert(0, ".")

import numpy as np

import jax

if not os.environ.get("GPSIG_EXAMPLE_DEVICE"):
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

# the reference's `import gpsig` becomes:
from gpsig import compat as gpsig
from gpsig import make_inducing_tensors_from_data
from gpsig.data.synthetic import classification_sequences, \
    train_test_split


def main():
    # -- data: ragged sequences -> scale, add time, pad, flatten ----------
    X, y = classification_sequences(seed=0, N=200, L=24, d=2, num_classes=3)
    Xtr, ytr, Xte, yte = train_test_split(X, y, 0.25, seed=0)
    scaler = gpsig.preprocessing.SequenceScaler().fit(Xtr)
    Xtr = gpsig.preprocessing.add_time_to_table(scaler.transform(Xtr))
    Xte = gpsig.preprocessing.add_time_to_table(scaler.transform(Xte))
    N, L, d = Xtr.shape
    C = 3
    Xtr_flat = gpsig.preprocessing.flatten_sequences(Xtr)
    Xte_flat = gpsig.preprocessing.flatten_sequences(Xte)

    # -- model: the reference's flagship configuration --------------------
    kern = gpsig.kernels.SignatureRBF(
        input_dim=L * d, num_features=d, num_levels=3, lengthscales=1.0,
        normalization=True,
    )
    feat_core = make_inducing_tensors_from_data(
        jax.random.PRNGKey(0), Xtr, num_tensors=40, num_levels=3,
        num_features=d, increments=True,
    )
    feat = gpsig.inducing_variables.InducingTensors(
        np.asarray(feat_core.raw_Z), 3, increments=True
    )
    model = gpsig.models.SVGP(
        Xtr_flat, ytr, kern, gpsig.likelihoods.MultiClass(C), feat=feat,
        num_latent=C, whiten=True, minibatch_size=50,
    )

    # -- training: alternating natgrad + Adam, the reference protocol -----
    nat = gpsig.training.NatGradOptimizer(gamma=0.1)
    adam = gpsig.training.AdamOptimizer(learning_rate=1e-2)
    print(f"initial ELBO: {model.compute_log_likelihood_full():.2f}")
    for it in range(60):
        nat.minimize(model, maxiter=1)
        adam.minimize(model, maxiter=1, freeze_variational=True)
    print(f"final ELBO:   {model.compute_log_likelihood_full():.2f}")

    # -- evaluation: accuracy + NLPP (the reference's reported metrics) ---
    p, _ = model.predict_y(Xte_flat)
    acc = float((p.argmax(1) == yte).mean())
    nlpp = float(-model.predict_density(Xte_flat, yte).mean())
    print(f"test accuracy {acc:.3f}   NLPP {nlpp:.3f}")
    assert acc > 1.5 / C, "should beat chance comfortably"


if __name__ == "__main__":
    main()
