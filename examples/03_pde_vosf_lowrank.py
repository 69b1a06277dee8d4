"""The scaling tracks: untruncated PDE kernel, VOSF (Kuu = I), low-rank
Nyström features.

SURVEY.md §2.2: the SigGPDE fork pairs the untruncated Goursat kernel with
variational orthogonal signature features so KL/natgrad cost is O(M); the
base repo's low-rank branch sketches explicit features for O(L) Grams.

Run: python examples/03_pde_vosf_lowrank.py
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

from gpsig import (
    SVGP,
    ExplicitSignatureKernel,
    OrthogonalSignatureFeatures,
    UntruncatedSignatureKernel,
    likelihoods,
)
from gpsig.kernels.low_rank import LowRankSignatureRBF
from gpsig.data import preprocessing as prep
from gpsig.data.synthetic import (
    classification_sequences,
    train_test_split,
)
from gpsig.training.loop import fit


def main():
    X, y = classification_sequences(seed=1, N=300, L=24, d=2,
                                    num_classes=2)
    Xtr, ytr, Xte, yte = train_test_split(X, y, 0.25, seed=1)
    sc = prep.SequenceScaler().fit(Xtr)
    Xtr = prep.add_time_to_table(sc.transform(Xtr))
    Xte = prep.add_time_to_table(sc.transform(Xte))
    d = Xtr.shape[-1]

    # --- untruncated PDE kernel (Goursat wavefront solve) --------------------
    pde = UntruncatedSignatureKernel.create(
        d, lengthscales=2.0, dyadic_order=1, normalization=True,
    )
    Kp = pde.K(jnp.asarray(Xtr[:4]))
    print("PDE kernel block:\n", np.round(np.asarray(Kp), 4))

    # --- VOSF: orthogonal signature features, Kuu = I ------------------------
    kern = ExplicitSignatureKernel.create(d, num_levels=4, lengthscales=2.0)
    feat = OrthogonalSignatureFeatures.for_kernel(kern)
    print("VOSF features (inducing dim):", feat.num_inducing)
    model = SVGP.create(kern, likelihoods.MultiClass(2), feat,
                        num_latent=2, q_diag=True)
    model, _ = fit(model, jnp.asarray(Xtr), jnp.asarray(ytr),
                   num_iters=200, learning_rate=5e-3, gamma=0.1,
                   log_every=100)
    p, _ = model.predict_y(jnp.asarray(Xte))
    acc = float((np.asarray(p).argmax(1) == yte).mean())
    print("VOSF test accuracy:", round(acc, 3))

    # --- the SigGPDE model: VOSF features UNDER the untruncated prior --------
    # Kuu = I, Kuf = rescaled signature coordinates of the PDE kernel's
    # Mercer expansion, Knn = the PDE kernel — the composition behind the
    # fork's 1M-series experiment (SURVEY.md §2.2 row 3). The truncation
    # gap Knn − ΣKuf² is genuine prior mass; the floored conditional
    # handles its finite-difference error.
    feat_pde = OrthogonalSignatureFeatures.for_kernel(pde, num_levels=4)
    print("VOSF-under-PDE features (inducing dim):", feat_pde.num_inducing)
    m2 = SVGP.create(pde, likelihoods.MultiClass(2), feat_pde,
                     num_latent=2, q_diag=True)
    m2, _ = fit(m2, jnp.asarray(Xtr), jnp.asarray(ytr),
                num_iters=150, learning_rate=5e-3, gamma=0.1,
                log_every=75)
    p2, _ = m2.posterior().predict_y(jnp.asarray(Xte))
    acc2 = float((np.asarray(p2).argmax(1) == yte).mean())
    print("SigGPDE (VOSF @ untruncated prior) test accuracy:",
          round(acc2, 3))

    # --- low-rank Nyström + sketched features --------------------------------
    lr = LowRankSignatureRBF(
        jax.random.PRNGKey(0), jnp.asarray(Xtr), d, num_levels=3,
        num_components=48, rank_bound=96,
    )
    Phi = lr.feature(jnp.asarray(Xtr[:8]))
    print("low-rank feature map shape:", Phi.shape,
          "(Gram cost O(N·c) instead of O(N²L²))")


if __name__ == "__main__":
    main()
