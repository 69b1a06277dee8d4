"""Synthetic sequence datasets (offline stand-ins for UEA/UCR).

The build machine has no network and no bundled UEA data (SURVEY.md §7:
"design the data layer around an offline directory + synthetic generators"),
so the staged BASELINE configs run on generators that mimic the relevant
dataset shapes: multivariate series with class-dependent temporal structure.
Real UEA/UCR archives drop in through ``gpsig.data.uea`` when present.
"""

from __future__ import annotations

import numpy as np


def regression_sequences(seed=0, N=200, L=50, d=2, noise=0.1):
    """BASELINE config 1: synthetic 2-D sequences with a smooth functional
    target (N=200, len=50) for Gram + exact GP regression."""
    rng = np.random.default_rng(seed)
    X = np.cumsum(0.3 * rng.standard_normal((N, L, d)), axis=1)
    # target: a smooth path functional (final value + signed area proxy)
    area = np.sum(X[:, :-1, 0] * np.diff(X[:, :, 1], axis=1), axis=1)
    y = np.tanh(X[:, -1, 0]) + 0.5 * np.tanh(area)
    y = y + noise * rng.standard_normal(N)
    return X.astype(np.float64), y[:, None].astype(np.float64)


def classification_sequences(
    seed=0, N=300, L=40, d=3, num_classes=3, difficulty=1.0
):
    """Class-dependent frequency + drift structure; higher ``difficulty``
    shrinks the separation. Returns (X [N, L, d], y [N] int)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, N)
    t = np.linspace(0, 1, L)
    X = np.empty((N, L, d))
    for n in range(N):
        c = y[n]
        freq = 1.0 + c
        drift = (c - (num_classes - 1) / 2.0) * 1.5 / difficulty
        base = 0.25 * rng.standard_normal((L, d)).cumsum(axis=0)
        phase = 2 * np.pi * rng.random(d)
        osc = np.sin(2 * np.pi * freq * t[:, None] + phase[None, :])
        X[n] = base + osc + drift * t[:, None]
    return X.astype(np.float64), y.astype(np.int32)


def sits_sequences(seed=0, N=100_000, L=40, num_classes=10):
    """SITS-like crop-classification stand-in (the fork's ~1M-series VOSF
    experiment — SURVEY.md §2.2): univariate NDVI-style seasonal profiles,
    double-logistic phenology with class-dependent green-up/senescence
    timing and amplitude, plus cloud-like dropouts and noise.

    Returns (X [N, L, 1], y [N]). Generated in blocks so N≈1e5+ stays
    cheap."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, N).astype(np.int32)
    t = np.linspace(0.0, 1.0, L)[None, :]
    # class phenology parameters
    base = np.linspace(0.25, 0.55, num_classes)  # green-up midpoint
    width = np.linspace(0.08, 0.2, num_classes)  # season half-length
    amp = np.linspace(0.5, 0.9, num_classes)  # NDVI amplitude
    g = base[y][:, None] + 0.03 * rng.standard_normal((N, 1))
    w = width[y][:, None] * np.exp(0.1 * rng.standard_normal((N, 1)))
    a = amp[y][:, None] * np.exp(0.1 * rng.standard_normal((N, 1)))
    k = 25.0
    ndvi = a * (
        1.0 / (1.0 + np.exp(-k * (t - g)))
        - 1.0 / (1.0 + np.exp(-k * (t - g - 2 * w)))
    ) + 0.15
    # cloud dropouts: random dips toward zero
    clouds = rng.random((N, L)) < 0.05
    ndvi = np.where(clouds, ndvi * rng.random((N, L)) * 0.3, ndvi)
    ndvi = ndvi + 0.03 * rng.standard_normal((N, L))
    return ndvi[:, :, None].astype(np.float64), y


def ragged_classification_sequences(seed=0, N=100, Lmin=20, Lmax=50, d=2,
                                    num_classes=2):
    """Variable-length variant (exercises repeat-last-observation padding)."""
    rng = np.random.default_rng(seed)
    Xf, y = classification_sequences(seed, N, Lmax, d, num_classes)
    seqs = []
    for n in range(N):
        L = int(rng.integers(Lmin, Lmax + 1))
        seqs.append(Xf[n, :L])
    return seqs, y


def train_test_split(X, y, test_frac=0.3, seed=0):
    rng = np.random.default_rng(seed)
    N = len(X) if isinstance(X, list) else X.shape[0]
    perm = rng.permutation(N)
    n_test = int(round(test_frac * N))
    te, tr = perm[:n_test], perm[n_test:]
    take = (lambda Z, idx: [Z[i] for i in idx]) if isinstance(X, list) else (
        lambda Z, idx: Z[idx]
    )
    return take(X, tr), y[tr], take(X, te), y[te]
