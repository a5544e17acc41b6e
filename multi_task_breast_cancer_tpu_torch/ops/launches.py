"""The launch counters of the port's kernel wrappers, in one registry.

Every wrapper that launches a hand-written kernel counts its launches in
its own ``launches`` attribute, and is registered here by :func:`counted`;
``_build.launch`` adds the one after each launch that succeeds, and
nothing else adds to it. A CUDA graph (:mod:`..graphs`) calls
every wrapper once while it captures but launches nothing then; it takes
the counters' growth over the capture as its launches per replay
(:func:`snapshot`, :func:`since`), puts the counters back
(:func:`restore`) and adds that growth at every replay (:func:`add`), so
the counters read as they would after the same steps run eagerly.
"""

from __future__ import annotations

from typing import Callable, Dict, List

REGISTRY: List[Callable] = []


def counted(fn: Callable) -> Callable:
    """Register ``fn`` as a counted entry point, its count starting at 0."""
    fn.launches = 0
    REGISTRY.append(fn)
    return fn


def snapshot() -> Dict[Callable, int]:
    return {fn: fn.launches for fn in REGISTRY}


def since(before: Dict[Callable, int]) -> Dict[Callable, int]:
    """Each counter's growth since ``before``; only the counters that grew."""
    grown = {fn: fn.launches - before.get(fn, 0) for fn in REGISTRY}
    return {fn: n for fn, n in grown.items() if n}


def restore(counts: Dict[Callable, int]) -> None:
    for fn, n in counts.items():
        fn.launches = n


def add(counts: Dict[Callable, int]) -> None:
    for fn, n in counts.items():
        fn.launches += n
