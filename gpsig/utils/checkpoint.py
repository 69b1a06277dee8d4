"""Checkpoint/resume as ``.npz`` archives of a pytree's leaves (SURVEY.md §5.4).

The reference relies on GPflow's Saver / ad-hoc numpy dumps; here any state
pytree (a TrainState with model, optimiser state and step, or the NUTS
sampler's nested dicts) is flattened, and each leaf is stored under its key
path in ``<path>/leaves.npz``. Restoring into a template rebuilds that
template's structure; restoring with ``template=None`` rebuilds nested dicts,
which is all a tree of dicts needs. Leaves are gathered to the host, so a
sharded state restores replicated; re-shard it with ``jax.device_put``.
"""

from __future__ import annotations

import os

import jax
import numpy as np

_FILE = "leaves.npz"
_SEP = "/"


def _key_name(path):
    parts = []
    for k in path:
        if isinstance(k, jax.tree_util.DictKey):
            parts.append(str(k.key))
        elif isinstance(k, jax.tree_util.GetAttrKey):
            parts.append(k.name)
        elif isinstance(k, jax.tree_util.SequenceKey):
            parts.append(str(k.idx))
        else:
            parts.append(str(k))
    return _SEP.join(parts)


def save_checkpoint(path, state):
    """Save a pytree state (e.g. training.loop.TrainState) to ``path``.

    The archive is written beside its final name and renamed into place, so
    an interrupted save never leaves a truncated ``leaves.npz``."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    leaves = jax.tree_util.tree_flatten_with_path(state)[0]
    arrays = {_key_name(p): np.asarray(v) for p, v in leaves}
    if len(arrays) != len(leaves):
        raise ValueError("checkpoint leaves have colliding key paths")
    tmp = os.path.join(path, _FILE + ".tmp.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, os.path.join(path, _FILE))


def restore_checkpoint(path, template):
    """Restore a state saved by save_checkpoint; ``template`` is a pytree
    with the right structure (e.g. a freshly built state), or None to get
    nested dicts of numpy arrays back."""
    path = os.path.abspath(path)
    with np.load(os.path.join(path, _FILE)) as z:
        arrays = {k: z[k] for k in z.files}
    if template is None:
        tree = {}
        for name, v in arrays.items():
            *parents, leaf = name.split(_SEP)
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = v
        return tree
    leaves, treedef = jax.tree_util.tree_flatten_with_path(template)
    out = []
    for p, t in leaves:
        name = _key_name(p)
        if name not in arrays:
            raise KeyError(f"checkpoint {path} has no leaf {name!r}")
        v = arrays[name]
        if np.shape(t) != v.shape:
            raise ValueError(
                f"leaf {name!r}: checkpoint shape {v.shape} != template "
                f"shape {np.shape(t)}"
            )
        out.append(jax.numpy.asarray(v) if isinstance(t, jax.Array) else v)
    return jax.tree_util.tree_unflatten(treedef, out)
