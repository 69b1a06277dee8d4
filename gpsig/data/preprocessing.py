"""Sequence preprocessing: padding, time augmentation, scaling.

Reference parity: ``gpsig/preprocessing.py`` (SURVEY.md §2.1) —
``tabulate_list_of_sequences`` pads ragged sequences **by repeating the
final observation**, which zeroes the padded increments so the signature
recursions are automatically masked (load-bearing trick: static shapes on
the device with no mask tensors anywhere); ``add_time_to_list`` appends a
normalised-time channel; channels are standard-scaled using train-set
statistics.
"""

from __future__ import annotations

import numpy as np


def tabulate_list_of_sequences(seqs, max_len=None):
    """List of [L_i, d] arrays → [N, L, d] padded by repeating the last
    observation (zero padded increments ⇒ recursion-invariant)."""
    if max_len is None:
        max_len = max(s.shape[0] for s in seqs)
    d = seqs[0].shape[1]
    out = np.empty((len(seqs), max_len, d), dtype=seqs[0].dtype)
    for n, s in enumerate(seqs):
        L = min(s.shape[0], max_len)
        out[n, :L] = s[:L]
        out[n, L:] = s[L - 1]
    return out


def add_time_to_list(seqs):
    """Append a normalised time channel t ∈ [0, 1] to each ragged sequence."""
    out = []
    for s in seqs:
        L = s.shape[0]
        t = np.linspace(0.0, 1.0, L, dtype=s.dtype).reshape(L, 1)
        out.append(np.concatenate([s, t], axis=1))
    return out


def add_time_to_table(X):
    """Append a normalised time channel to padded sequences [N, L, d].

    Note: applied *after* padding, the time channel keeps increasing through
    the pad region; apply to ragged lists first (add_time_to_list) to keep
    padded increments zero — the reference's pipeline does time-then-pad
    (SURVEY.md §3.5)."""
    N, L, d = X.shape
    t = np.broadcast_to(
        np.linspace(0.0, 1.0, L, dtype=X.dtype).reshape(1, L, 1), (N, L, 1)
    )
    return np.concatenate([X, t], axis=2)


class SequenceScaler:
    """Per-channel standard scaler fit on the training sequences.

    Fits on all (non-padding-aware) observations; matches the reference
    benchmarks' sklearn StandardScaler over stacked observations."""

    def __init__(self):
        self.mean_ = None
        self.std_ = None

    def fit(self, seqs):
        if isinstance(seqs, np.ndarray):
            flat = seqs.reshape(-1, seqs.shape[-1])
        else:
            flat = np.concatenate([s for s in seqs], axis=0)
        self.mean_ = flat.mean(axis=0)
        self.std_ = flat.std(axis=0) + 1e-12
        return self

    def transform(self, seqs):
        if isinstance(seqs, np.ndarray):
            return (seqs - self.mean_) / self.std_
        return [(s - self.mean_) / self.std_ for s in seqs]

    def fit_transform(self, seqs):
        return self.fit(seqs).transform(seqs)


def flatten_sequences(X):
    """[N, L, d] → [N, L*d] (the reference's flattened input convention)."""
    return X.reshape(X.shape[0], -1)
