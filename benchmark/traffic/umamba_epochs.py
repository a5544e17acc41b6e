"""Training traffic of the U-Mamba_Enc cell: ``engine_epochs``'s driver of
the same folder, unchanged, with U-Mamba_Enc's plain reference
(``benchmark/reference/umamba.py``) entered into the reference models
first.

The reference models are looked up in a closed dict
(``benchmark/reference/models.py``, ``MODELS``), which a change that adds a
configuration may not edit: it may only add files to the benchmark. A
traffic kind is imported before anything builds the reference (the kind is
the mix's name up to its first dot), so this one enters ``UMambaEnc`` there
and hands every run to ``engine_epochs.run``.
"""

from pathlib import Path

from benchmark import harness
from benchmark.reference import models, umamba

models.MODELS.setdefault("UMambaEnc", umamba.UMambaEnc)
_ENGINE_EPOCHS = harness.traffic_driver("engine_epochs", Path(__file__).resolve().parents[1])


def run(ctx) -> dict:
    return _ENGINE_EPOCHS.run(ctx)
