"""The window attention of a SwinUNETR configuration, counted on the plain
reference: the windows, heads and tokens of every attention site of one
forward, and the least time of the softmax launches at those sites from the
bytes each must move (:func:`counters.bound_s`).

A site's softmax runs over the last axis of its (windows · batch, heads,
tokens, tokens) logits. Its forward reads the logits and writes the
probabilities; its backward reads the probabilities and their gradient and
writes the logits' gradient.
"""

from __future__ import annotations

from typing import List, Tuple

from benchmark import counters

SOFTMAX_FWD_FLOPS_PER_ELEMENT = 5  # max, subtract, exp, sum, divide
SOFTMAX_BWD_FLOPS_PER_ELEMENT = 4  # product, sum, subtract, multiply


def attention_sites(torch, cfg: dict, size: int = None) -> List[Tuple[int, int, int]]:
    """(windows, heads, tokens) of one image at every ``WindowAttention``
    call of one forward of the configuration's reference model, in forward
    order, read by forward hooks on meta tensors (``size`` the input side,
    the configuration's by default)."""
    from benchmark.reference import models
    size = cfg["size"] if size is None else size
    kwargs = dict(cfg["reference_kwargs"], size=size)
    with torch.device("meta"):
        model = models.build(cfg["reference_model"], **kwargs)
    sites = []

    def hook(module, inputs, _):
        windows, tokens, _ = inputs[0].shape
        sites.append((windows, module.heads, tokens))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, models.WindowAttention)]
    try:
        with torch.no_grad():
            model(torch.zeros(1, cfg["channels"], size, size, device="meta"))
    finally:
        for h in handles:
            h.remove()
    return sites


def _elements(site: Tuple[int, int, int], batch: int) -> int:
    windows, heads, tokens = site
    return batch * windows * heads * tokens * tokens


def softmax_forward_bound_s(sites, batch: int, itemsize: int = 4) -> float:
    """The softmax forward at every site of one forward: logits read,
    probabilities written."""
    return sum(counters.bound_s(_elements(s, batch), itemsize, 2, SOFTMAX_FWD_FLOPS_PER_ELEMENT)
               for s in sites)


def softmax_backward_bound_s(sites, batch: int, itemsize: int = 4) -> float:
    """The softmax backward at every site of one step: probabilities and
    their gradient read, the logits' gradient written."""
    return sum(counters.bound_s(_elements(s, batch), itemsize, 3, SOFTMAX_BWD_FLOPS_PER_ELEMENT)
               for s in sites)
