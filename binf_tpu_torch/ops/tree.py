"""Vector-space helpers over positions (port of ``binf_tpu/ops/tree.py``).

A position is a tensor or a dict of named tensors with their own shapes
(scalar precision, coefficient vector, ...); nested dicts, lists and tuples
are walked too.  Dict leaves are visited in sorted-key order, as JAX
flattens a dict.  Random draws take a ``torch.Generator`` where the JAX
package takes a key.
"""

from __future__ import annotations

import torch

__all__ = [
    "tree_add",
    "tree_axpy",
    "tree_dot",
    "tree_leaves",
    "tree_map",
    "tree_normal_like",
    "tree_scale",
    "tree_size",
    "tree_split_keys",
    "tree_sub",
    "tree_uniform_like",
    "tree_where",
    "tree_zeros_like",
]


def tree_map(fn, tree, *rest):
    """``fn`` applied leafwise over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *parts) for parts in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [tree]


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(c, a):
    return tree_map(lambda x: c * x, a)


def tree_axpy(c, x, y):
    """y + c * x, leafwise."""
    return tree_map(lambda xi, yi: yi + c * xi, x, y)


def tree_dot(a, b) -> torch.Tensor:
    parts = tree_leaves(tree_map(lambda x, y: torch.sum(x * y), a, b))
    return torch.stack(parts).sum() if parts else torch.zeros(())


def tree_size(a) -> int:
    return sum(torch.as_tensor(x).numel() for x in tree_leaves(a))


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def tree_where(pred, a, b):
    """Select whole tree a or b on a predicate (accept/reject)."""
    return tree_map(lambda x, y: torch.where(pred, x, y), a, b)


def tree_split_keys(generator: torch.Generator, template):
    """One ``torch.Generator`` per leaf, each seeded from ``generator``, as
    a tree shaped like ``template``."""
    n = len(tree_leaves(template))
    seeds = iter(torch.randint(0, 2**62, (n,), generator=generator,
                               device=generator.device).tolist())

    def child(_):
        return torch.Generator(device=generator.device).manual_seed(next(seeds))

    return tree_map(child, template)


def tree_normal_like(generator: torch.Generator, template):
    gens = tree_split_keys(generator, template)
    return tree_map(
        lambda g, x: torch.randn(x.shape, generator=g, dtype=x.dtype,
                                 device=g.device).to(x.device),
        gens, template,
    )


def tree_uniform_like(generator: torch.Generator, template, low: float = -1.0,
                      high: float = 1.0):
    gens = tree_split_keys(generator, template)
    return tree_map(
        lambda g, x: (low + (high - low) * torch.rand(
            x.shape, generator=g, dtype=x.dtype, device=g.device)).to(x.device),
        gens, template,
    )
