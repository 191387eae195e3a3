"""CommConfig — the typed communication config behind one LaneComm.

Counterpart of ``repro.comm.config``: the gradient-sync strategy, its
bucket count and the rest of a LaneComm's tuning surface in one frozen
dataclass.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:  # pragma: no cover - typing only, avoids an import cycle
    from repro_torch.configs.base import RunConfig

_COMPRESSIONS = ("none", "int8")


@dataclasses.dataclass(frozen=True)
class CommConfig:
    """Tuning surface of one :class:`~repro_torch.comm.LaneComm`.

    strategy: default strategy for ``grad_sync`` (and any collective for
        which that name is registered).  ``"auto"`` ranks the registered
        auto-eligible implementations with the cost model per call.
    buckets: gradient-sync bucket count K; 0 = cost-model auto (the §5
        latency/bandwidth crossover, ``core.costmodel.optimal_num_buckets``).
    prefetch_blocks: ZeRO-3 per-layer weight-gather pipeline blocks B;
        0 = cost-model auto, >0 = override, -1 = BLOCKING gather (the
        negative control: ``prefetch_allgather`` dispatches to the
        ``"blocking"`` strategy).
    compression: lane payload compression ("none" | "int8").  Descriptive
        — ``lane_int8`` is never auto-selected (lossy); this records that
        the owner opted in.
    record_selections: append a Selection record per auto dispatch.
    tuner: measured-cost hook (a :class:`~repro_torch.tuning.Tuner`, or
        None): auto dispatch ranks measured cells ahead of the cost
        model's.  It changes which registered strategy runs, never what a
        strategy computes.
    """

    strategy: str = "auto"
    buckets: int = 0
    prefetch_blocks: int = 0
    compression: str = "none"
    record_selections: bool = True
    tuner: Optional[object] = None

    def __post_init__(self):
        if self.compression not in _COMPRESSIONS:
            raise ValueError(
                f"unknown compression {self.compression!r}; "
                f"have {_COMPRESSIONS}")
        if self.strategy != "auto":
            from .registry import (has_impl, registered_collectives,
                                   unported_item)
            item = unported_item("grad_sync", self.strategy)
            if item is not None and not has_impl("grad_sync",
                                                 self.strategy):
                raise NotImplementedError(
                    f"strategy {self.strategy!r} is not ported yet "
                    f"({item})")
            if not any(has_impl(c, self.strategy)
                       for c in registered_collectives()):
                raise ValueError(
                    f"unknown strategy {self.strategy!r}: not registered "
                    f"for any collective (inspect the tables via "
                    f"repro_torch.comm.strategies_for)")

    @classmethod
    def from_run(cls, run: "RunConfig") -> "CommConfig":
        """From the run's ``gradsync``, ``gradsync_buckets`` and
        ``fsdp_prefetch``."""
        return cls(
            strategy=run.gradsync,
            buckets=run.gradsync_buckets,
            prefetch_blocks=run.fsdp_prefetch,
            compression="int8" if run.gradsync == "lane_int8" else "none",
        )
