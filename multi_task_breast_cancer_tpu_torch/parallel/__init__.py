"""Data parallelism and spatial partitioning over ``torch.distributed``: the
mesh and its sharding helpers (:mod:`.mesh`), the ``space`` axis's
collectives (:mod:`.spatial`), and multi-process start-up (:mod:`.multihost`)."""

from multi_task_breast_cancer_tpu_torch.parallel.mesh import (  # noqa: F401
    DataMesh,
    data_mesh,
    data_space_mesh,
    device_count,
    replicate_to_mesh,
)
