"""Global numeric policy for gpsig.

The reference stack (GPflow 1.x) runs float64 end-to-end
(``gpflow.settings.float_type``) with a default jitter of 1e-6. The GPU's
fast paths are float32 (and TF32 inside matmuls unless a precision is asked
for), so the policy here is split:

- *parity* mode: float64 (requires ``jax.config.update("jax_enable_x64", True)``)
  — used by the oracle test-suite to match the reference bit-for-bit-ish.
- *throughput* mode: float32 — used by benchmarks and ``chip_smoke.py``.

Library code is dtype-polymorphic: it computes in the dtype of its inputs and
only consults this module for constants (jitter) and default initialisation
dtypes.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp


@dataclasses.dataclass
class Settings:
    """Mutable global settings (mirrors gpflow.settings's role)."""

    #: jitter added to Kuu / Cholesky factorisations (gpflow default: 1e-6)
    jitter: float = 1e-6
    #: jitter floor for float32 factorisations. Inducing-tensor Grams are
    #: structurally rank-deficient (most eigenvalues < 1e-6 even in f64), so
    #: the f64 default sits below f32 rounding error — chol then NaNs
    #: depending on the backend's accumulation order.
    jitter_f32: float = 1e-4
    #: default dtype for parameter initialisation
    default_float: jnp.dtype = jnp.float32


settings = Settings()


def default_float():
    return settings.default_float


def default_jitter(dtype=None):
    """Jitter for Cholesky factorisations; dtype-aware when dtype is given
    (float32 needs a larger floor than GPflow's f64 default — see
    ``Settings.jitter_f32``)."""
    if dtype is not None and jnp.dtype(dtype) == jnp.float32:
        return max(settings.jitter, settings.jitter_f32)
    return settings.jitter


def precise_linalg(fn):
    """Trace ``fn`` under float32 matmul precision.

    On the GPU a float32 matmul may run in TF32 (about three decimal
    digits) unless a precision is asked for, and that default also governs
    the blocked matmuls *inside* ``cholesky`` / ``triangular_solve``
    lowerings. The GP layer (conditionals, KL, natural-gradient updates)
    differences nearly-equal quantities through those solves, so reduced-
    precision passes produce negative predictive variances → NaN, while the
    same code is healthy on CPU f32. These ops are O(M³)/O(M²B) with
    M≈500 — pinning them to f32 costs nothing next to the Gram engine
    (which manages its own precision). Explicit ``precision=`` args are not
    overridden; f64 inputs are unaffected.
    """

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("float32"):
            return fn(*args, **kwargs)

    return wrapped
