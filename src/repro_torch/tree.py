"""Parameter trees: nested dicts, lists, tuples and NamedTuples with tensors
(or arrays) at the leaves, walked in one order everywhere.

Dict keys are visited in sorted order, as JAX's pytrees visit them, so the
params, grads and optimizer moments of the port line up leaf for leaf with
each other and with the reference's.  A NamedTuple is checked before a
tuple.  A leaf's path is the key the checkpoint manifest stores it under:
``embed``, ``layers/[0]/wq``, ``/mu/embed`` (a NamedTuple field or a list
index joins its parent's path with ``/`` even when that path is empty).
"""
from __future__ import annotations


def tree_map_with_path(fn, tree, *rest, path: str = ""):
    """``fn(path, leaf, *the leaves at the same place in rest)`` over the
    leaves of ``tree``, keeping its structure."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], *(r[k] for r in rest),
                                      path=f"{path}/{k}" if path else str(k))
                for k in sorted(tree)}
    if hasattr(tree, "_fields"):                # NamedTuple, before tuple
        return type(tree)(*[
            tree_map_with_path(fn, getattr(tree, n),
                               *(getattr(r, n) for r in rest),
                               path=f"{path}/{n}")
            for n in tree._fields])
    if isinstance(tree, (list, tuple)):
        return type(tree)([
            tree_map_with_path(fn, v, *(r[i] for r in rest),
                               path=f"{path}/[{i}]")
            for i, v in enumerate(tree)])
    return fn(path, tree, *rest)


def tree_map(fn, tree, *rest):
    """``fn(leaf, *the leaves at the same place in rest)`` over the leaves
    of ``tree``, keeping its structure."""
    return tree_map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``tree_map``'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(template, leaves):
    """``template``'s structure holding ``leaves`` (in ``tree_leaves``'
    order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)
