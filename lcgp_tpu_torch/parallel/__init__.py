"""Multi-device fitting, prediction and serving over ``torch.distributed``
(counterpart of ``lcgp_tpu/parallel``): one process per device, each
running the same program (see :mod:`.group`).  ``make_mesh`` and
``fit_sharded`` are the ('comp','out') mesh (:mod:`.mesh`); the n-sharded
paths are :mod:`.nshard` (exact) and :mod:`.fitc_shard` (FITC)."""
from . import fitc_shard
from .group import Mesh, WorkerGroup, init_distributed
from .mesh import (data_shardings, fit_sharded, make_mesh,
                   make_sharded_value_and_grad, param_shardings, place)

__all__ = ["make_mesh", "param_shardings", "data_shardings", "place",
           "make_sharded_value_and_grad", "fit_sharded", "init_distributed",
           "Mesh", "WorkerGroup", "fitc_shard"]
