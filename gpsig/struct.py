"""Frozen dataclasses that are JAX pytrees.

Every model object (kernels, likelihoods, inducing variables, models) is a
``@struct.dataclass``: its array fields are pytree leaves, so the whole model
jits, differentiates and shards as one pytree, while fields declared with
``struct.field(pytree_node=False)`` are static metadata (part of the treedef,
hence of the jit cache key). ``obj.replace(**changes)`` returns an updated
copy.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node=True, **kwargs):
    """``dataclasses.field`` with a ``pytree_node`` flag (False = static)."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    """Make ``cls`` a frozen dataclass registered as a JAX pytree."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (data if f.metadata.get("pytree_node", True) else meta).append(f.name)
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = _replace
    return cls
