"""Pytrees of tensors for the port: nested dicts, NamedTuples, lists and
tuples with tensor (or numpy) leaves, visited in JAX's flatten order —
dict keys SORTED, NamedTuple fields in declaration order — and named
with JAX's key-path rule (``.field`` for NamedTuple fields, the key for
dicts, the index for sequences, joined with ``/``). The checkpoint
stream's record order and names rest on this order."""
from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _flatten_into(out: list, x, path: list):
    # module level, not a nested closure: a recursive closure reaches
    # itself through its own cell, and that cycle would keep ``out``,
    # and with it every leaf, alive until a full collection
    if _is_leaf(x):
        out.append(("/".join(path), x))
    elif isinstance(x, dict):
        for k in sorted(x):
            _flatten_into(out, x[k], path + [str(k)])
    elif _is_namedtuple(x):
        for f in x._fields:
            _flatten_into(out, getattr(x, f), path + ["." + f])
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            _flatten_into(out, v, path + [str(i)])
    elif x is not None:
        raise TypeError(f"unsupported checkpoint leaf {type(x)!r} at "
                        f"{'/'.join(path)!r}")


def flatten(state) -> List[Tuple[str, Any]]:
    """``[(name, leaf), ...]`` in the reference's stream order."""
    out: List[Tuple[str, Any]] = []
    _flatten_into(out, state, [])
    return out


def _rebuild(x, path: list, named: dict):
    if _is_leaf(x):
        return named["/".join(path)]
    if isinstance(x, dict):
        return {k: _rebuild(v, path + [str(k)], named) for k, v in x.items()}
    if _is_namedtuple(x):
        return type(x)(*(_rebuild(getattr(x, f), path + ["." + f], named)
                         for f in x._fields))
    if isinstance(x, (list, tuple)):
        return type(x)(_rebuild(v, path + [str(i)], named)
                       for i, v in enumerate(x))
    return x


def unflatten(like, named: dict):
    """Rebuild ``like``'s structure with ``named[name]`` at each leaf."""
    return _rebuild(like, [], named)


def treedef_str(state) -> str:
    """Printable structure of ``state`` (debugging only; ``*`` marks a
    leaf)."""
    if _is_leaf(state):
        return "*"
    if isinstance(state, dict):
        return "{" + ", ".join(f"{k!r}: {treedef_str(state[k])}"
                               for k in sorted(state)) + "}"
    if _is_namedtuple(state):
        return type(state).__name__ + "(" + ", ".join(
            f"{f}={treedef_str(getattr(state, f))}"
            for f in state._fields) + ")"
    if isinstance(state, (list, tuple)):
        return "[" + ", ".join(treedef_str(v) for v in state) + "]"
    return "None"


def leaves(tree) -> list:
    """The leaves of ``tree`` in flatten order."""
    return [leaf for _, leaf in flatten(tree)]


def tree_map(fn, tree):
    """``tree`` with ``fn`` applied to every leaf."""
    return unflatten(tree, {name: fn(leaf) for name, leaf in flatten(tree)})
