"""Shared helpers for the staged benchmark configs (BASELINE.md).

This directory is the rebuild's analogue of the reference's ``benchmarks/``
scripts (SURVEY.md §2.1: per-dataset drivers; train/val early stopping;
test accuracy + NLPP reporting). Datasets: local UEA archives when present
(``GPSIG_DATA_DIR``), synthetic generators otherwise (zero-egress
machine — SURVEY.md §7).
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def base_parser(desc):
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--x64", action="store_true",
                   help="float64 parity mode (CPU)")
    p.add_argument("--cpu", action="store_true", help="force CPU backend")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--iters", type=int, default=None)
    return p


def setup_jax(args):
    """Apply --cpu/--x64 and the compile-cache rule:
    ``$JAX_COMPILATION_CACHE_DIR`` when set, else ``.jax_cache`` in the
    checkout."""
    import os

    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        jax.config.update("jax_compilation_cache_dir",
                          os.path.join(root, ".jax_cache"))
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.x64:
        jax.config.update("jax_enable_x64", True)
    return jax


def report(**kw):
    print(json.dumps(kw, default=float))


def accuracy_and_nlpp(model, X, y, key=None):
    """Test accuracy + negative log predictive probability (the reference's
    reporting pair)."""
    import jax.numpy as jnp

    p, _ = model.predict_y(jnp.asarray(X))
    p = np.asarray(p)
    acc = float((p.argmax(1) == np.asarray(y)).mean())
    nlpp = float(
        -np.mean(np.log(p[np.arange(len(y)), np.asarray(y)] + 1e-12))
    )
    return acc, nlpp


def get_classification_data(dataset, seed, synth_kwargs=None):
    """UEA dataset if available locally, else synthetic fallback."""
    from gpsig.data import preprocessing as prep
    from gpsig.data import synthetic, uea, uea_like

    loader = None
    if dataset and dataset in uea.available_datasets():
        loader = uea.load_dataset
    elif dataset and dataset in uea_like.available_datasets():
        loader = lambda name: uea_like.load_dataset(name)  # noqa: E731
    if loader is not None:
        Xtr_l, ytr, Xte_l, yte = loader(dataset)
        scaler = prep.SequenceScaler().fit(Xtr_l)
        Xtr_l = prep.add_time_to_list(scaler.transform(Xtr_l))
        Xte_l = prep.add_time_to_list(scaler.transform(Xte_l))
        L = max(max(s.shape[0] for s in Xtr_l),
                max(s.shape[0] for s in Xte_l))
        Xtr = prep.tabulate_list_of_sequences(Xtr_l, L)
        Xte = prep.tabulate_list_of_sequences(Xte_l, L)
        return Xtr, ytr, Xte, yte, dataset
    kw = dict(seed=seed, N=400, L=40, d=3, num_classes=3)
    kw.update(synth_kwargs or {})
    X, y = synthetic.classification_sequences(**kw)
    Xtr, ytr, Xte, yte = synthetic.train_test_split(X, y, 0.3, seed)
    scaler = prep.SequenceScaler().fit(Xtr)
    Xtr, Xte = scaler.transform(Xtr), scaler.transform(Xte)
    Xtr, Xte = prep.add_time_to_table(Xtr), prep.add_time_to_table(Xte)
    return Xtr, ytr, Xte, yte, "synthetic"
