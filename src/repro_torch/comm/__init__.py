"""repro_torch.comm — the communicator-object collective API (the paper's
§2 made first-class), counterpart of ``repro.comm``.

One :class:`LaneComm` = one decomposed communication domain
(:class:`~repro_torch.core.lane.LaneTopology`, its node and lane process
groups) + one typed tuning surface (:class:`CommConfig`), exposing the
collective surface through a decorator-based implementation registry
with cost-model auto-dispatch::

    comm = LaneComm(topo, CommConfig.from_run(run))
    comm.grad_sync(grads)                          # cfg-default strategy
    out = comm.allreduce(x, strategy="auto")       # cost-model pick,
    comm.last_selection                            #   recorded here
"""
from .config import CommConfig
from .lanecomm import LaneComm, Selection
from .layout import param_layout_kind, register_param_layout
from .registry import (
    ImplEntry, get_impl, has_impl, iter_impls, register_impl,
    registered_collectives, strategies_for,
)
from . import impls as _impls  # populate the registry  # noqa: F401

__all__ = [
    "LaneComm", "CommConfig", "Selection",
    "ImplEntry", "register_impl", "get_impl", "has_impl", "iter_impls",
    "strategies_for", "registered_collectives",
    "register_param_layout", "param_layout_kind",
]
