"""Nested model outputs: a model returns a tensor, a tuple or list of them
(deep supervision, multitask heads) or a dict (an exported program's compact
answer); :func:`tree_map` applies a function leaf by leaf."""

from __future__ import annotations


def tree_map(fn, *trees):
    """``fn`` over the matching leaves of ``trees``, nested dicts, tuples and
    lists of the same structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)
