"""Offline UEA/UCR archive loaders (.ts and .arff), no sktime dependency.

Reference parity: the reference's benchmark scripts load UEA/UCR datasets via
``sktime``'s arff reader (SURVEY.md §3.5). sktime is not installed here and
the machine has no network, so this is a small self-contained parser for the
two archive formats. Point ``GPSIG_DATA_DIR`` (or the ``root`` argument)
at a directory containing ``<Name>/<Name>_TRAIN.ts`` etc.
"""

from __future__ import annotations

import os

import numpy as np


def data_dir(root=None):
    return root or os.environ.get("GPSIG_DATA_DIR", "/root/data/UEA")


def available_datasets(root=None):
    root = data_dir(root)
    if not os.path.isdir(root):
        return []
    out = []
    for name in sorted(os.listdir(root)):
        d = os.path.join(root, name)
        if os.path.isdir(d) and (
            os.path.exists(os.path.join(d, f"{name}_TRAIN.ts"))
            or os.path.exists(os.path.join(d, f"{name}_TRAIN.arff"))
        ):
            out.append(name)
    return out


def load_dataset(name, root=None):
    """Returns (train_seqs, y_train, test_seqs, y_test): lists of [L_i, d]
    float arrays + integer label arrays."""
    root = data_dir(root)
    base = os.path.join(root, name, name)
    if os.path.exists(base + "_TRAIN.ts"):
        tr = _parse_ts(base + "_TRAIN.ts")
        te = _parse_ts(base + "_TEST.ts")
    elif os.path.exists(base + "_TRAIN.arff"):
        tr = _parse_arff(base + "_TRAIN.arff")
        te = _parse_arff(base + "_TEST.arff")
    else:
        raise FileNotFoundError(
            f"no {name}_TRAIN.ts/.arff under {os.path.dirname(base)}"
        )
    (Xtr, ytr), (Xte, yte) = tr, te
    labels = sorted(set(ytr) | set(yte))
    lut = {lab: i for i, lab in enumerate(labels)}
    ytr = np.array([lut[v] for v in ytr], np.int32)
    yte = np.array([lut[v] for v in yte], np.int32)
    return Xtr, ytr, Xte, yte


def _parse_ts(path):
    """Parse sktime .ts: lines of 'dim1vals:dim2vals:...:label' after
    @data; dims are comma-separated floats ('?' = missing → ffill).

    Dispatches to the native C++ parser (native/fastts.cpp via
    gpsig/data/_native.py) when available — ~7× faster (135 MB/s) on
    large archives; this Python path is the fallback and oracle."""
    from gpsig.data import _native

    nat = _native.parse_ts(path)
    if nat is not None:
        return nat
    return _parse_ts_py(path)


def _parse_ts_py(path):
    seqs, labels = [], []
    with open(path, "r", errors="replace") as f:
        in_data = False
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if not in_data:
                if line.lower().startswith("@data"):
                    in_data = True
                continue
            parts = line.split(":")
            labels.append(parts[-1].strip())
            dims = []
            for p in parts[:-1]:
                vals = [
                    np.nan if v.strip() in ("?", "") else float(v)
                    for v in p.split(",")
                ]
                dims.append(np.asarray(vals, np.float64))
            L = max(len(v) for v in dims)
            arr = np.full((L, len(dims)), np.nan)
            for j, v in enumerate(dims):
                arr[: len(v), j] = v
            seqs.append(_ffill(arr))
    return seqs, labels


def _parse_arff(path):
    """Parse UEA relational or flat univariate ARFF."""
    seqs, labels = [], []
    with open(path, "r", errors="replace") as f:
        in_data = False
        relational = False
        for line in f:
            line = line.strip()
            if not line or line.startswith("%"):
                continue
            low = line.lower()
            if not in_data:
                if "@attribute" in low and "relational" in low:
                    relational = True
                if low.startswith("@data"):
                    in_data = True
                continue
            if relational:
                # 'dim1a,dim1b,...\ndim2a,...',label  (quoted, \n-separated)
                q0 = line.find("'")
                q1 = line.rfind("'")
                body = line[q0 + 1 : q1]
                label = line[q1 + 1 :].lstrip(",").strip()
                rows = body.split("\\n")
                dims = [
                    np.asarray(
                        [
                            np.nan if v.strip() in ("?", "") else float(v)
                            for v in r.split(",")
                        ],
                        np.float64,
                    )
                    for r in rows
                ]
                L = max(len(v) for v in dims)
                arr = np.full((L, len(dims)), np.nan)
                for j, v in enumerate(dims):
                    arr[: len(v), j] = v
                seqs.append(_ffill(arr))
                labels.append(label)
            else:
                vals = line.split(",")
                labels.append(vals[-1].strip())
                x = np.asarray(
                    [
                        np.nan if v.strip() in ("?", "") else float(v)
                        for v in vals[:-1]
                    ],
                    np.float64,
                )
                seqs.append(_ffill(x[:, None]))
    return seqs, labels


def _ffill(arr):
    """Forward-fill NaNs along time (then back-fill leading NaNs)."""
    out = arr.copy()
    for j in range(out.shape[1]):
        col = out[:, j]
        mask = np.isnan(col)
        if mask.all():
            out[:, j] = 0.0
            continue
        idx = np.where(~mask, np.arange(len(col)), 0)
        np.maximum.accumulate(idx, out=idx)
        col = col[idx]
        # leading NaNs: backfill with first valid
        first = np.argmax(~mask)
        col[:first] = col[first]
        out[:, j] = col
    return out
