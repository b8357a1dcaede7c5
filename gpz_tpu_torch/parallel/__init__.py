"""Sharded and multi-process training on torch.distributed
(gpz_tpu.parallel): the (restart, data) mesh of ranks, the row-sharded
objective and its training loop, the restart-split ensemble step, and the
multi-process entry."""

from gpz_tpu_torch.parallel.mesh import make_mesh, DATA_AXIS, RESTART_AXIS
from gpz_tpu_torch.parallel import distributed
from gpz_tpu_torch.parallel.sharded import (
    shard_dataset,
    sharded_value_and_grad,
    sharded_nlog_ml,
    sharded_holdout_metrics,
    train_sharded,
    ensemble_grad_step,
)

__all__ = [
    "make_mesh",
    "DATA_AXIS",
    "RESTART_AXIS",
    "shard_dataset",
    "sharded_value_and_grad",
    "sharded_nlog_ml",
    "sharded_holdout_metrics",
    "train_sharded",
    "ensemble_grad_step",
    "distributed",
]
