"""Data-parallel training and serving across ranks, one process a GPU
(``mesh.py``), the spawned worlds that run them on one machine
(``launch.py``) and the multi-GPU dry run (``dryrun.py``)."""

from exposure_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    Mesh,
    data_parallel_mesh,
    local_batch_size,
    pad_to_devices,
)
