"""Multi-device fitting and prediction over ``torch.distributed``
(counterpart of ``lcgp_tpu/parallel``): one process per device, each
running the same program (see :mod:`.group`).  ``make_mesh`` and
``fit_sharded`` are the ('comp','out') mesh (:mod:`.mesh`); the n-sharded
path is :mod:`.nshard`."""
from .group import Mesh, WorkerGroup, init_distributed
from .mesh import (data_shardings, fit_sharded, make_mesh,
                   make_sharded_value_and_grad, param_shardings, place)

__all__ = ["make_mesh", "param_shardings", "data_shardings", "place",
           "make_sharded_value_and_grad", "fit_sharded", "init_distributed",
           "Mesh", "WorkerGroup"]
