"""Frozen-dataclass infrastructure (port of ``binf_tpu/core/modules.py``).

Every model and density object of the DSL is an immutable dataclass: its
tensor fields hold data and hyperparameters, the rest (names, shapes,
callables) is configuration.  The JAX package registers these classes as
pytrees so that ``jit`` traces the data and keys its cache on the rest;
PyTorch runs eagerly and differentiates with ``torch.func`` through
closures, so here the split is documentation only: :func:`static_field`
marks a configuration field in its metadata, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, TypeVar

T = TypeVar("T")

__all__ = ["field", "frozen_dataclass", "replace", "static_field"]


def static_field(**kwargs: Any) -> Any:
    """A dataclass field holding configuration rather than data."""
    metadata = dict(kwargs.pop("metadata", {}) or {})
    metadata["static"] = True
    return dataclasses.field(metadata=metadata, **kwargs)


def field(**kwargs: Any) -> Any:
    """A regular (data) dataclass field."""
    return dataclasses.field(**kwargs)


def frozen_dataclass(cls: type[T] | None = None):
    """Decorator: an immutable dataclass compared by identity, the port's
    counterpart of ``pytree_dataclass``."""

    def wrap(c: type[T]) -> type[T]:
        return dataclasses.dataclass(frozen=True, eq=False)(c)

    return wrap(cls) if cls is not None else wrap


def replace(obj: T, **changes: Any) -> T:
    """Functional update of a frozen dataclass (``dataclasses.replace``)."""
    return dataclasses.replace(obj, **changes)
