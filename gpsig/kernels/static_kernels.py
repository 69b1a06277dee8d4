"""Static (state-space) base kernels lifted into the signature machinery.

Reference parity: ``gpsig/kernels.py`` bottom — ``SignatureLinear``,
``SignatureRBF``, ``SignaturePoly``, ``SignatureCosine`` implement
``_base_kern`` on R^d (SURVEY.md §2.1). In this rebuild the base kernels are
parameter-light pytree dataclasses; ARD lengthscales are owned by the
:class:`~gpsig.kernels.signature.SignatureKernel` (it pre-scales the
inputs), matching the reference's division of labor.

Each base kernel provides
- ``gram(A, B)``: [..., n, d] × [..., m, d] → [..., n, m]
- ``matched(A, B)``: [..., d] × [..., d] → [...] (paired evaluation, used for
  inducing-tensor factor Grams).

The big seq-vs-seq Grams reduce to one matmul (`A @ B^T`, plus norms for
the stationary kernels) — the FLOP-heavy part of Gram construction.
"""

from __future__ import annotations

import jax.numpy as jnp
from gpsig import struct

from gpsig import params as pr


def _dot(A, B):
    # d (the contraction dim) is small, so full-f32 precision (no TF32)
    # costs ~nothing here while the downstream DP compounds any base-Gram
    # rounding.
    return jnp.matmul(A, jnp.swapaxes(B, -1, -2), precision="highest")


def _sqdist(A, B):
    na = jnp.sum(A * A, axis=-1)
    nb = jnp.sum(B * B, axis=-1)
    d2 = na[..., :, None] + nb[..., None, :] - 2.0 * _dot(A, B)
    return jnp.maximum(d2, 0.0)


@struct.dataclass
class LinearBase:
    """k(a, b) = ⟨a, b⟩ (reference: SignatureLinear's _base_kern)."""

    def gram(self, A, B):
        return _dot(A, B)

    def matched(self, A, B):
        return jnp.sum(A * B, axis=-1)


@struct.dataclass
class RBFBase:
    """k(a, b) = exp(-||a - b||² / 2) on pre-scaled inputs (SignatureRBF)."""

    def gram(self, A, B):
        return jnp.exp(-0.5 * _sqdist(A, B))

    def matched(self, A, B):
        d = A - B
        return jnp.exp(-0.5 * jnp.sum(d * d, axis=-1))


@struct.dataclass
class PolyBase:
    """k(a, b) = (⟨a, b⟩ + c)^degree (SignaturePoly); c is trainable."""

    raw_offset: jnp.ndarray
    degree: int = struct.field(pytree_node=False, default=2)

    @classmethod
    def create(cls, offset=1.0, degree=2, dtype=jnp.float32):
        return cls(
            raw_offset=jnp.asarray(pr.inv_positive(offset), dtype),
            degree=degree,
        )

    @property
    def offset(self):
        return pr.positive(self.raw_offset)

    def gram(self, A, B):
        return (_dot(A, B) + self.offset) ** self.degree

    def matched(self, A, B):
        return (jnp.sum(A * B, axis=-1) + self.offset) ** self.degree


@struct.dataclass
class CosineBase:
    """k(a, b) = cos(||a - b||) on pre-scaled inputs.

    Marked low-confidence in SURVEY.md (§2.1 row 'Base-kernel subclasses':
    SignatureCosine [L]); behavior follows GPflow 1.x's stationary ``Cosine``.
    """

    def gram(self, A, B):
        return jnp.cos(jnp.sqrt(_sqdist(A, B) + 1e-36))

    def matched(self, A, B):
        d = A - B
        return jnp.cos(jnp.sqrt(jnp.sum(d * d, axis=-1) + 1e-36))
