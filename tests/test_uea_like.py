"""Frozen synthetic UEA-like suite: determinism + a fast end-to-end
sanity check. The full accuracy-window regression harness is
``benchmarks/run_all.py`` (too slow for the unit suite at the frozen
2000-iteration protocol); this file pins what must never drift silently:
the generated data itself, and that the standard protocol actually
learns on it."""

import json
import os

import numpy as np

import jax
import jax.numpy as jnp

from gpsig.data import uea_like

WINDOWS = os.path.join(os.path.dirname(__file__), os.pardir,
                       "benchmarks", "expected_windows.json")


def test_generators_are_deterministic():
    for name in uea_like.available_datasets():
        a = uea_like.load_dataset(name)
        b = uea_like.load_dataset(name)
        for x, y in zip(a[0][:3], b[0][:3]):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(a[1], b[1])


def test_suite_shapes_and_labels():
    specs = {
        "SynthGunPoint": (2, 1), "SynthBasicMotions": (4, 6),
        "SynthLibras": (15, 2), "SynthERing": (6, 4),
        "SynthCharTraj": (10, 3),
    }
    for name, (C, d) in specs.items():
        Xtr, ytr, Xte, yte = uea_like.load_dataset(name)
        assert Xtr[0].shape[1] == d
        assert set(np.unique(np.concatenate([ytr, yte]))) <= set(range(C))
        assert len(Xtr) == len(ytr) and len(Xte) == len(yte)


def test_fingerprints_match_committed_windows():
    """The accuracy windows are only valid against these exact arrays —
    any generator drift must fail loudly here, not as a silent window
    miss."""
    if not os.path.exists(WINDOWS):
        import pytest

        pytest.skip("expected_windows.json not calibrated yet")
    windows = json.load(open(WINDOWS))
    for name, win in windows.items():
        base = name.split("@", 1)[0]  # '<dataset>@<variant>' suite entries
        assert uea_like.dataset_fingerprint(base) == win["fingerprint"], (
            f"{name}: generated data drifted from the calibrated windows"
        )


def test_protocol_learns_on_smallest_dataset():
    """Short-budget end-to-end check (full windows live in run_all.py):
    the standard protocol on SynthERing must beat chance clearly within
    300 iterations."""
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
    from benchmarks.run_all import PROTOCOL, run_dataset

    class A:
        x64 = True
        iters = 300

    res = run_dataset("SynthERing", A, protocol=PROTOCOL)
    chance = 1.0 / res["num_classes"]
    assert res["acc"] > 1.8 * chance, res
    assert np.isfinite(res["nlpp"])
