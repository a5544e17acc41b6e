"""The selective scans of a U-Mamba_Enc configuration, counted on the plain
reference: the channels and steps of every scan of one forward, and the
least time of the scan's launches at those sites (:func:`counters.bound_s`
in spirit: every input byte read once and every output byte written once at
3.35 TB/s, or the f32 arithmetic at 67 TFLOP/s where that is larger).

The bytes are the algorithm's own and nothing an implementation saves (the
port's kernel keeps every state for its backward; that traffic is not
counted). A forward launch reads u, δ̂ and z (batch, L, d_inner), B and C
(batch, L, N), A (d_inner, N), D and the step's bias (d_inner), and writes
y (batch, L, d_inner). A backward launch reads those and dy, and writes du,
dδ̂ and dz, dB and dC, dA, dD and the bias's gradient.
"""

from __future__ import annotations

from typing import List, Tuple

from benchmark import counters

D_STATE = 16
# per (sample, channel, step, state): the step times A, its exp, the state's
# multiply-add (2) and the input's product (1), C times the state added (2)
SCAN_FWD_FLOPS_PER_ELEMENT = 7
# the state's recomputation as forward (7), the adjoint's update (2) and
# decay (1), dC (1), dā (1), the step's two terms (6), dA (3), du (3)
SCAN_BWD_FLOPS_PER_ELEMENT = 24


def scan_sites(torch, cfg: dict, size: int = None) -> List[Tuple[int, int, int]]:
    """(d_inner, L, N) of one image's scan at every Mamba layer of one
    forward of the configuration's reference model, in forward order, read
    by forward hooks on meta tensors (``size`` the input side, the
    configuration's by default)."""
    from benchmark.reference import umamba
    size = cfg["size"] if size is None else size
    kwargs = dict(cfg["reference_kwargs"], size=size)
    with torch.device("meta"):
        model = umamba.UMambaEnc(**kwargs)
    sites = []

    def hook(module, inputs, _):
        _, steps, _ = inputs[0].shape
        sites.append((module.d_inner, steps, module.A_log.shape[1]))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, umamba.Mamba)]
    try:
        with torch.no_grad():
            model(torch.zeros(1, cfg["channels"], size, size, device="meta"))
    finally:
        for h in handles:
            h.remove()
    return sites


def _bound_s(nbytes: int, flops: int) -> float:
    return max(nbytes / counters.HBM_BYTES_PER_S, flops / counters.PEAK_FLOPS["float32"])


def scan_forward_bound_s(sites, batch: int, itemsize: int = 4) -> float:
    """The forward at every site of one forward: u, δ̂, z, B, C, A, D and
    the bias read, y written."""
    return sum(_bound_s(itemsize * (4 * batch * steps * dn + 2 * batch * steps * n
                                    + dn * n + 2 * dn),
                        SCAN_FWD_FLOPS_PER_ELEMENT * batch * dn * steps * n)
               for dn, steps, n in sites)


def scan_backward_bound_s(sites, batch: int, itemsize: int = 4) -> float:
    """The backward at every site of one step: the forward's inputs and dy
    read; du, dδ̂, dz, dB, dC, dA, dD and the bias's gradient written."""
    return sum(_bound_s(itemsize * (7 * batch * steps * dn + 4 * batch * steps * n
                                    + 2 * dn * n + 4 * dn),
                        SCAN_BWD_FLOPS_PER_ELEMENT * batch * dn * steps * n)
               for dn, steps, n in sites)
