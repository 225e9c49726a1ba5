"""Train and eval steps of the port, on one device or on a ``(data,
model)`` mesh of ranks (``parallel/mesh.py``), and the gloo CPU dryrun of
the mesh (``parallel/dryrun.py``)."""

from routeformer_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    MeshParams,
    batch_spec,
    init_distributed,
    make_mesh,
    param_shardings,
    param_spec,
    shard_batch,
    shard_params,
)
from routeformer_torch.parallel.train_step import make_eval_step, make_train_step

__all__ = ["DATA_AXIS", "MODEL_AXIS", "MeshParams", "batch_spec", "init_distributed",
           "make_eval_step", "make_mesh", "make_train_step", "param_shardings", "param_spec",
           "shard_batch", "shard_params"]
