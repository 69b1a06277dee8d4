"""ctypes bindings for the native .ts parser (native/fastts.cpp).

The shared library is built on demand with g++ (cached next to the source,
keyed by a source hash) — no pybind11/pip machinery needed. Everything is
failure-tolerant: any problem (no compiler, parse rejection such as the
timestamped .ts dialect) returns None and the caller falls back to the pure
Python parser in gpsig/data/uea.py.

Set ``GPSIG_NO_NATIVE=1`` to disable.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_lock = threading.Lock()
_lib = None
_tried = False


def _source_path():
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(__file__))),
        "native", "fastts.cpp",
    )


def _build(src):
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    cache = os.environ.get(
        "GPSIG_NATIVE_CACHE",
        os.path.join(os.path.dirname(src), ".build"),
    )
    os.makedirs(cache, exist_ok=True)
    so = os.path.join(cache, f"fastts-{tag}.so")
    if os.path.exists(so):
        return so
    tmp = so + f".tmp{os.getpid()}"
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
           src, "-o", tmp]
    subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    os.replace(tmp, so)  # atomic under concurrent builders
    return so


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("GPSIG_NO_NATIVE"):
            return None
        try:
            so = _build(_source_path())
            lib = ctypes.CDLL(so)
            lib.fastts_parse.restype = ctypes.c_void_p
            lib.fastts_parse.argtypes = [ctypes.c_char_p]
            lib.fastts_num_series.argtypes = [ctypes.c_void_p]
            lib.fastts_num_dims.argtypes = [ctypes.c_void_p]
            lib.fastts_labels_size.argtypes = [ctypes.c_void_p]
            lib.fastts_labels_size.restype = ctypes.c_longlong
            lib.fastts_get_labels.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p]
            lib.fastts_get_lengths.argtypes = [
                ctypes.c_void_p,
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ]
            lib.fastts_get_values.argtypes = [
                ctypes.c_void_p, ctypes.c_int,
                np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ]
            lib.fastts_free.argtypes = [ctypes.c_void_p]
            _lib = lib
        except Exception:  # noqa: BLE001 - fall back to the Python parser
            _lib = None
        return _lib


def parse_ts(path):
    """Parse a .ts file natively. Returns (list of [L_i, d] float64 arrays,
    list of label strings), or None to request the Python fallback."""
    lib = _load()
    if lib is None:
        return None
    h = lib.fastts_parse(os.fsencode(path))
    if not h:
        return None
    try:
        n = lib.fastts_num_series(h)
        d = lib.fastts_num_dims(h)
        lengths = np.empty(n, np.int32)
        lib.fastts_get_lengths(h, lengths)
        lsize = lib.fastts_labels_size(h)
        buf = ctypes.create_string_buffer(int(lsize))
        lib.fastts_get_labels(h, buf)
        labels = buf.raw[:lsize].decode("utf-8", "replace").split("\n")
        seqs = []
        for i in range(n):
            arr = np.empty((int(lengths[i]), d), np.float64)
            lib.fastts_get_values(h, i, arr)
            seqs.append(arr)
        if len(labels) != n:
            return None
        return seqs, labels
    finally:
        lib.fastts_free(h)
