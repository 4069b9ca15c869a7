"""Frozen dataclasses registered as JAX pytrees.

Engine layers, packed models and the train state are immutable records of
arrays: the array fields are pytree leaves, and fields made with
:func:`static` (shapes, modes, callables) are part of the treedef, so they
are compile-time constants under ``jax.jit``.  Instances pickle like any
module-level dataclass, which is what ``qnx convert`` artifacts rely on.
"""
from __future__ import annotations

import dataclasses

import jax


def static(default=dataclasses.MISSING):
    """A field that is static metadata, not a pytree leaf."""
    return dataclasses.field(default=default, metadata=dict(static=True))


def pytree_dataclass(cls):
    """``@dataclass(frozen=True)`` + pytree registration + ``replace``."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **kw: dataclasses.replace(self, **kw)
    return jax.tree_util.register_dataclass(cls)
