"""Signature kernels 101: Gram matrices, kernel options, exact GP regression.

Mirrors the reference's introductory notebook (SURVEY.md §2.1 'Notebooks'):
build signature kernels over sequences, inspect per-level structure, and fit
an exact GP regressor on a path functional.

Run: python examples/01_signature_kernel_basics.py   (CPU-friendly)
"""

import sys

sys.path.insert(0, ".")

import numpy as np

import jax

# examples default to CPU float64 (the parity mode); set GPSIG_EXAMPLE_DEVICE=1
# to run on the accelerator in float32.
import os
if not os.environ.get("GPSIG_EXAMPLE_DEVICE"):
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

from gpsig import (
    GPR,
    SignatureLinear,
    SignatureRBF,
    UntruncatedSignatureKernel,
)
from gpsig.data.synthetic import regression_sequences


def main():
    # --- data: N sequences of length L in R^d -------------------------------
    X, y = regression_sequences(seed=0, N=80, L=30, d=2)
    Xtr, ytr = jnp.asarray(X[:60]), jnp.asarray(y[:60])
    Xte, yte = jnp.asarray(X[60:]), jnp.asarray(y[60:])

    # --- a truncated signature kernel ---------------------------------------
    # num_levels: signature truncation; order: per-step exponential
    # truncation (order >= num_levels = exact piecewise-linear signature);
    # normalization: per-level k_m / sqrt(k_m(x,x) k_m(y,y)).
    kern = SignatureRBF(
        num_features=2, num_levels=4, lengthscales=1.0, order=2,
        normalization=True,
    )
    K = kern.K(Xtr[:5])
    print("Gram block:\n", np.round(np.asarray(K), 4))

    # per-level contributions (level 0 is the constant):
    levels = kern.K(Xtr[:3], Xtr[:3], return_levels=True)
    print("per-level k_m(x0, x1):", np.round(np.asarray(levels[:, 0, 1]), 5))

    # the untruncated (PDE / SigGPDE) kernel for comparison:
    pde = UntruncatedSignatureKernel.create(2, lengthscales=1.0,
                                            dyadic_order=1)
    print("PDE kernel block:\n",
          np.round(np.asarray(pde.K(Xtr[:3])), 4))

    # --- exact GP regression -------------------------------------------------
    model = GPR.create(kern, noise_variance=0.05)
    print("log marginal likelihood:",
          float(model.log_marginal_likelihood(Xtr, ytr)))
    mean, var = model.predict_y(Xtr, ytr, Xte)
    rmse = float(jnp.sqrt(jnp.mean((mean - yte) ** 2)))
    print("test RMSE:", round(rmse, 4),
          " (predict-the-mean baseline:",
          round(float(jnp.std(yte)), 4), ")")


if __name__ == "__main__":
    main()
