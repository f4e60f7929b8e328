"""Checkpoint and resume of a whole sampler state (port of
``binf_tpu/io/checkpoint.py``).

A state is a tree of NamedTuples, dicts, lists and tuples whose leaves are
tensors, ``torch.Generator`` objects, Python scalars or None: the eager
samplers' states, the production driver's carries.  A generator is saved
as its ``get_state()``, so a resumed run continues the same stream and
reproduces the uninterrupted run's draws.

:func:`save_checkpoint` writes the leaves with ``torch.save`` (one file,
written beside the target and renamed over it, so a crash mid-save leaves
the previous checkpoint whole); :func:`load_checkpoint` reads it with
``weights_only=True`` against a template of the same structure and puts
every tensor on the template's device with its dtype.  The JAX package
saves with Orbax into a directory; neither machine of the port has Orbax,
and here the path names one file.  :func:`save_npz`/:func:`load_npz` keep
the same leaves in a numpy ``.npz`` archive.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

__all__ = ["load_checkpoint", "load_npz", "save_checkpoint", "save_npz"]


def _leaves(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` pairs in a fixed order: NamedTuple fields and list
    items in order, dict keys sorted."""
    if hasattr(tree, "_fields"):
        items = [(f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), x) for i, x in enumerate(tree)]
    else:
        return [(prefix, tree)]
    return [leaf for name, sub in items
            for leaf in _leaves(sub, f"{prefix}.{name}" if prefix else name)]


def _rebuild(template: Any, values: dict, prefix: str = "") -> Any:
    """``template``'s structure with each leaf restored from ``values``."""
    if hasattr(template, "_fields"):
        return type(template)(*(_rebuild(getattr(template, f), values,
                                          f"{prefix}.{f}" if prefix else f)
                                for f in template._fields))
    if isinstance(template, dict):
        return {k: _rebuild(template[k], values, f"{prefix}.{k}" if prefix else str(k))
                for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(x, values, f"{prefix}.{i}" if prefix else str(i))
                              for i, x in enumerate(template))
    return _restore_leaf(template, values[prefix], prefix)


def _encode(leaf: Any) -> Any:
    if isinstance(leaf, torch.Generator):
        return leaf.get_state()
    if torch.is_tensor(leaf):
        return leaf.detach().cpu()
    return leaf


def _restore_leaf(template: Any, saved: Any, path: str) -> Any:
    if isinstance(template, torch.Generator):
        g = torch.Generator(device=template.device)
        g.set_state(torch.as_tensor(saved, dtype=torch.uint8))
        return g
    if torch.is_tensor(template):
        saved = torch.as_tensor(saved)
        if tuple(saved.shape) != tuple(template.shape):
            raise ValueError(f"checkpoint leaf {path!r} has shape {tuple(saved.shape)}, "
                             f"the template {tuple(template.shape)}")
        return saved.to(device=template.device, dtype=template.dtype)
    return saved.item() if isinstance(saved, np.ndarray) else saved


def save_checkpoint(path: str, state: Any, force: bool = True) -> None:
    """Save ``state`` to the file ``path`` (``force=False``: refuse to
    overwrite an existing one)."""
    path = os.path.abspath(path)
    if not force and os.path.exists(path):
        raise FileExistsError(path)
    tmp = f"{path}.tmp"
    torch.save({name: _encode(leaf) for name, leaf in _leaves(state)}, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, template: Any) -> Any:
    """Restore a state saved by :func:`save_checkpoint`.  ``template`` (for
    example the freshly built initial state) gives the structure, and each
    tensor's shape, dtype and device; a generator comes back on its
    template's device.  A missing file raises ``FileNotFoundError``."""
    saved = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    return _rebuild(template, saved)


def save_npz(path: str, state: Any) -> None:
    """The same leaves in a numpy ``.npz`` archive (numpy appends ``.npz``
    to a path without it)."""
    arrays = {}
    for i, (_, leaf) in enumerate(_leaves(state)):
        enc = _encode(leaf)
        arrays[f"leaf_{i}"] = enc.numpy() if torch.is_tensor(enc) else np.asarray(enc)
    np.savez(path, **arrays)


def load_npz(path: str, template: Any) -> Any:
    """Restore a state saved by :func:`save_npz` against ``template``."""
    data = np.load(path)
    names = [name for name, _ in _leaves(template)]
    return _rebuild(template, {name: data[f"leaf_{i}"] for i, name in enumerate(names)})
