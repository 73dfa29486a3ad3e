"""Frozen-dataclass pytrees.

Subclassing :class:`PyTreeNode` turns a class with annotated fields into a
frozen dataclass registered with ``jax.tree_util.register_dataclass``: every
field is a pytree child (traced through ``jit``/``vmap``/``scan``) unless it
was declared with ``field(static=True)``, which makes it part of the treedef
(hashed, compared, never traced).  ``.replace(**changes)`` returns a copy with
some fields swapped, as ``dataclasses.replace`` does.
"""

from __future__ import annotations

import dataclasses

import jax


def field(*, static: bool = False, **kwargs):
    """A dataclass field; ``static=True`` keeps it out of the pytree leaves."""
    return dataclasses.field(metadata={"static": static}, **kwargs)


class PyTreeNode:
    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(frozen=True)(cls)
        fields = dataclasses.fields(cls)
        jax.tree_util.register_dataclass(
            cls,
            data_fields=[f.name for f in fields if not f.metadata.get("static")],
            meta_fields=[f.name for f in fields if f.metadata.get("static")],
        )

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)
