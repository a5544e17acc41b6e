"""Nested model outputs: a model returns a tensor, a tuple or list of them
(deep supervision, multitask heads) or a dict (an exported program's compact
answer); :func:`tree_map` applies a function leaf by leaf, and
:func:`multitask_pair` reads a multitask output's class and seg parts."""

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


def multitask_pair(out):
    """A multitask output as ``(cls, seg)``. Adityan's triple
    ``(cls, reconstruction, seg)`` drops its reconstruction: the reference
    defines no loss or inference for that head, so the network trains, is
    tested and serves as its seg + cls pair, as in JAX."""
    if isinstance(out, (tuple, list)) and len(out) == 3:
        return out[0], out[2]
    cls, seg = out
    return cls, seg
