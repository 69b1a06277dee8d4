"""GPSig-style inducing-variable classes.

Reference: ``gpsig/inducing_variables.py`` — ``InducingTensors(Z,
num_levels, increments=..., learn_weights=...)`` and
``InducingSequences(Z)`` with ``len(feat)`` giving the number of inducing
variables (SURVEY.md §2.1). Wraps the functional families in
``gpsig/inducing.py``; ``Kuu``/``Kuf`` take the *compat* kernel and
unwrap it, mirroring the reference's GPflow ``features.Kuu(feat, kern)``
dispatch pairs.
"""

from __future__ import annotations

import numpy as np

from gpsig import inducing as core
from gpsig.kernels.vosf import OrthogonalSignatureFeatures


def _unwrap(kern):
    return kern.to_functional() if hasattr(kern, "to_functional") else kern


class _Wrapper:
    def __len__(self):
        return self._feat.num_inducing

    @property
    def Z(self):
        return np.asarray(self._feat.raw_Z)

    def to_functional(self):
        return self._feat

    def update_functional(self, feat):
        self._feat = feat

    def Kuu(self, kern, jitter=None):
        return self._feat.Kuu(_unwrap(kern), jitter)

    def Kuf(self, kern, X):
        return self._feat.Kuf(_unwrap(kern), X)


class InducingTensors(_Wrapper):
    def __init__(self, Z, num_levels, increments=False, learn_weights=False):
        self._feat = core.InducingTensors.create(
            Z, num_levels, increments=increments, learn_weights=learn_weights
        )


class InducingSequences(_Wrapper):
    def __init__(self, Z, num_levels=None, joint_psd=False):
        # num_levels accepted for signature parity; the sequence family
        # reuses the kernel's own truncation level. joint_psd: see
        # gpsig.inducing.InducingSequences.covariances_full (the
        # joint-PSD training guarantee for FD/PDE kernels).
        del num_levels
        self._feat = core.InducingSequences.create(Z, joint_psd=joint_psd)


class OrthogonalFeatures(_Wrapper):
    """VOSF inter-domain features (fork — ``Kuu = I``; SURVEY.md §2.2).

    Takes either the *explicit* signature kernel
    (``gpsig.kernels.vosf.ExplicitSignatureKernel`` — the
    self-consistent truncated lift) or, with ``num_levels``, the
    **untruncated** PDE kernel (``compat.kernels.UntruncSignatureKernel``
    / ``gpsig.kernels.pde.UntruncatedSignatureKernel``) — the
    reference SigGPDE model: ``Kuf`` = rescaled signature coordinates of
    the untruncated prior's Mercer expansion, ``Knn`` = PDE kernel."""

    def __init__(self, kern, num_levels=None):
        self._feat = OrthogonalSignatureFeatures.for_kernel(
            _unwrap(kern), num_levels=num_levels
        )
