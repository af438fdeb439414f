"""Frozen dataclasses that are JAX pytrees.

``@dataclass`` makes a frozen ``dataclasses.dataclass`` and registers it
with ``jax.tree_util.register_dataclass``, so its array fields flow
through ``jit`` / ``grad`` / ``vmap`` / ``shard_map`` as leaves. Fields
declared with ``field(static=True)`` are part of the tree structure
(hashable metadata such as a leaf size), not leaves. ``.replace(**kw)``
returns a copy with some fields changed.
"""

from __future__ import annotations

import dataclasses

import jax


def field(*, static: bool = False, **kwargs):
    """``dataclasses.field`` that marks a field static (not a leaf)."""
    metadata = dict(kwargs.pop("metadata", None) or {}, static=static)
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    """Frozen dataclass registered as a pytree, with a ``replace`` method."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (meta if f.metadata.get("static") else data).append(f.name)
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = _replace
    return cls
