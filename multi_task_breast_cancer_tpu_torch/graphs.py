"""Captured CUDA programs: the port's counterpart of JAX's compiled ones.

The JAX package jits a whole training epoch and compiles one serving
program per batch bucket, so nothing is traced online. The port runs its
ops from Python, one launch at a time, and the host issuing those launches
sets the pace of a small step. A :class:`Program` removes that: one function
captured once as a CUDA graph (``torch.cuda.CUDAGraph``) on static input
tensors, then replayed. The training Engine captures its step
(``train/loop.py``), the serving backends one forward per (replica, bucket)
(``serve/server.py``, ``serve/export.py``); no other module captures.

- **One rule** (:func:`enabled`): a run is graphed on a CUDA device without
  a mesh, and under a data mesh whose step holds one collective, the
  gradient all-reduce between the backward and the optimizer's step (the
  Engine captures the two parts around it and runs the all-reduce eagerly
  between their replays). It is eager on the CPU, under a ``(data ×
  space)`` mesh (halo exchanges inside every convolution) and under a data
  mesh for a model whose forward calls a collective
  (:data:`..models.blocks.FORWARD_COLLECTIVES`): a graph does not hold the
  process group's collectives.
- **No fallback**: a capture that fails raises; nothing catches it and runs
  the eager path instead.
- **Static tensors**: the inputs are tensors allocated before the capture;
  :meth:`Program.replay` copies new values into them (``copy_``, outside the
  graph) and every replay overwrites the same output tensors, which the
  caller copies out before the next replay.
- **Memory**: the capture runs on a side stream into a private memory pool,
  or into a pool that several programs share (:func:`new_pool`; a serving
  replica's buckets, which run one at a time on its stream; the two parts
  of a data-mesh training step, the second reading what the first wrote).
- **Launch counts**: a capture calls every kernel wrapper once but launches
  nothing. The counters of :mod:`.ops.launches` are snapshot before the
  capture, their growth is kept as the program's launches per replay, the
  counters are put back, and each replay adds that growth: they read as
  after the same calls run eagerly.
- **Random draws**: a program captured with a ``generator`` (a CUDA
  ``torch.Generator`` that the function draws from) registers it with the
  graph; a replay hands it the caller's generator state first and gives the
  advanced state back after, so the draws are the eager run's bit for bit
  and the caller's generator ends where the eager run leaves it.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch

from multi_task_breast_cancer_tpu_torch.ops import launches


def enabled(device, mesh=None, model=None) -> bool:
    """Whether a run of ``model`` on ``device`` under ``mesh`` is graphed: a
    CUDA device, and either no mesh or a data mesh without a ``space`` group
    for a model (required then) whose forward calls no collective. The one
    rule; the Engine and the backends ask it."""
    if torch.device(device).type != "cuda":
        return False
    if mesh is None:
        return True
    # imported here: an artifact's loader asks the rule and imports no model code
    from multi_task_breast_cancer_tpu_torch.models.blocks import has_forward_collective
    return mesh.space is None and not has_forward_collective(model)


def new_pool():
    """A memory pool that several programs may share (programs captured
    into it must run one at a time, in the order they were captured)."""
    return torch.cuda.graph_pool_handle()


class Program:
    """``fn(*inputs)`` captured once as a CUDA graph on ``device``.

    ``inputs``: the static input tensors (allocated by the caller, on
    ``device``); ``fn`` returns the outputs (any tree of tensors), exposed as
    :attr:`outputs`. ``stream`` is the capture's side stream (default a new
    one), ``pool`` a :func:`new_pool` to share (default a private pool).
    Whatever ``fn`` needs that must exist before a capture (optimizer state,
    a loaded kernel library, cuDNN's algorithm choice, a cache filled from
    the host) comes from an eager call of the same work on ``stream`` before
    the program is built."""

    def __init__(self, fn: Callable[..., Any], inputs: Sequence[torch.Tensor], device, *,
                 stream: Optional[torch.cuda.Stream] = None, pool=None,
                 generator: Optional[torch.Generator] = None):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, got {device}")
        self.inputs = list(inputs)
        self.generator = generator
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        stream = stream if stream is not None else torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        before = launches.snapshot()
        try:
            with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                self.outputs = fn(*self.inputs)
        finally:
            self.launches = launches.since(before)
            launches.restore(before)
        torch.cuda.current_stream(device).wait_stream(stream)

    def replay(self, *sources: Optional[torch.Tensor],
               generator: Optional[torch.Generator] = None) -> Any:
        """Copy ``sources`` into the static inputs (``None`` leaves one as it
        is), replay on the current stream and count its launches; draws come
        from ``generator``'s state, which advances as the eager run's would.
        Returns :attr:`outputs`, valid until the next replay."""
        for static, source in zip(self.inputs, sources):
            if source is not None:
                static.copy_(source)
        if generator is not None:
            self.generator.set_state(generator.get_state())
        self.graph.replay()
        launches.add(self.launches)
        if generator is not None:
            generator.set_state(self.generator.get_state())
        return self.outputs

    def close(self) -> None:
        """Release the graph and drop the static tensors, so that its pool
        can be freed once nothing else holds memory from it."""
        self.graph.reset()
        self.inputs, self.outputs = [], None
