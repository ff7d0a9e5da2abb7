"""The port's parameter and optimizer-state trees, walked in JAX's order.

A tree is nested dicts, NamedTuples (``OptState``), lists or tuples, with
tensors (or any other object) at the leaves; ``None`` is an empty subtree.
``jax.tree_util`` visits a dict's keys SORTED and a NamedTuple's fields in
declaration order; so does this module. Two things depend on it: the
global gradient norm, whose fp32 sum over the leaves then adds in the
reference's order, and checkpoint keys, which are the ``/``-joined paths
the reference writes (``params/blocks/attn/wq``, ``opt/mu/embed``,
``opt/step``).
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

Path = Tuple[str, ...]


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_path(tree: Any, prefix: Path = ()
                      ) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) pairs in JAX's flatten order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten_with_path(tree[k], prefix + (str(k),))
    elif _is_namedtuple(tree):
        for f in tree._fields:
            yield from flatten_with_path(getattr(tree, f), prefix + (f,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten_with_path(v, prefix + (str(i),))
    else:
        yield prefix, tree


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def path_key(path: Path) -> str:
    """The reference's checkpoint key of a leaf: its path joined by ``/``."""
    return "/".join(path)


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of each
    tree in ``rest``), keeping ``tree``'s structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, getattr(tree, f),
                                     *(getattr(r, f) for r in rest))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def map_with_path(fn: Callable[[Path, Any], Any], tree: Any,
                  prefix: Path = ()) -> Any:
    """``fn(path, leaf)`` over the leaves, keeping the structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_path(fn, getattr(tree, f), prefix + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


__all__ = ["flatten_with_path", "leaves", "map_with_path", "path_key",
           "tree_map"]
