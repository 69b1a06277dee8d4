"""Likelihood constructors under the GPflow 1.x names the reference uses.

Reference: ``gpsig/likelihoods.py`` plus GPflow's
``likelihoods.{Gaussian, Bernoulli, MultiClass, SoftMax}`` (SURVEY.md
§2.1/§2.3). These return the functional pytrees directly — they are
already stateless dataclasses with the GPflow method surface
(``variational_expectations``, ``predict_mean_and_var``,
``predict_log_density``).
"""

from __future__ import annotations

import jax.numpy as jnp

from gpsig import likelihoods as core


def Gaussian(variance=1.0, dtype=jnp.float64):
    return core.Gaussian.create(variance=variance, dtype=dtype)


def Bernoulli():
    return core.Bernoulli()


def MultiClass(num_classes, epsilon=1e-3):
    """RobustMax multiclass (GPflow 1.x ``MultiClass`` default)."""
    return core.MultiClass(num_classes=num_classes, epsilon=epsilon)


def SoftMax(num_classes, num_samples=100):
    """Monte-Carlo softmax (the reference's MC multiclass likelihood)."""
    return core.Softmax(num_classes=num_classes, num_samples=num_samples)


Softmax = SoftMax
