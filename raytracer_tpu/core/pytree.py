"""Frozen dataclass pytrees for the package's state types.

``jax.tree_util.register_dataclass`` over a frozen dataclass, plus the
``.replace(**changes)`` method the rest of the code uses to derive
updated copies. Fields declared with ``field(pytree_node=False)`` are
static metadata (part of the treedef, not leaves).
"""

from __future__ import annotations

import dataclasses

import jax


def dataclass(cls):
    """Make ``cls`` a frozen dataclass registered as a JAX pytree."""
    cls = dataclasses.dataclass(frozen=True)(cls)

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    cls.replace = replace
    return jax.tree_util.register_dataclass(cls)


def field(*, pytree_node: bool = True, **kwargs):
    """A dataclass field; ``pytree_node=False`` marks it static."""
    return dataclasses.field(metadata={"static": not pytree_node}, **kwargs)
