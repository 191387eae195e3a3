"""LaneComm — the MPI-style communicator object over a LaneTopology.

Counterpart of ``repro.comm.lanecomm``.  One object carries the
factorization (:class:`~repro_torch.core.lane.LaneTopology`, its process
groups), the tuning surface (:class:`~repro_torch.comm.config.CommConfig`)
and the collective surface — ``allreduce``/``reduce_scatter``/
``allgather``/``bcast``/``alltoall``/``reduce``/``gather``/``scatter``/
``scan`` plus the training collectives ``grad_sync`` and
``prefetch_allgather``.  Every method
resolves through the implementation registry
(:mod:`~repro_torch.comm.registry`); ``strategy="auto"`` ranks the
registered implementations with the §3/§5 cost model and records the
choice.  Every process of the topology must make the same call.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch import _tree
from repro_torch.core.lane import LaneTopology

from .config import CommConfig
from .registry import get_impl, has_impl, iter_impls, strategies_for

__all__ = ["LaneComm", "Selection"]


@dataclasses.dataclass(frozen=True)
class Selection:
    """One recorded auto-dispatch decision.

    ranking: ((seconds, strategy), ...) — the full cost table the choice
    was made from.  Ascending in seconds; with a tuner attached, measured
    cells sort ahead of modelled ones (so seconds are ascending only
    within each tier).  source: where the winning cost came from —
    ``"measured"`` (timing cache, ``cfg.tuner``) or ``"model"`` (the §3/§5
    closed form).
    """
    collective: str
    strategy: str
    payload_bytes: int
    ranking: tuple
    source: str = "model"


def _payload_bytes(x: Any) -> int:
    """Wire-relevant payload size: a tensor's bytes, or a tree's elements
    at 4 B each (grad_sync flattens to f32)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return sum(l.numel() for l in _tree.leaves(x)) * 4


def _lead(x: Any) -> Optional[int]:
    """Leading dim for feasibility checks; None for trees (impls pad)."""
    if isinstance(x, torch.Tensor) and x.ndim >= 1:
        return x.shape[0]
    return None


class LaneComm:
    """The (node × lane) communicator object (see module docstring).

    selections: Selection records of every auto dispatch, in call order.
    """

    def __init__(self, topo: LaneTopology, cfg: Optional[CommConfig] = None):
        self.topo = topo
        self.cfg = cfg if cfg is not None else CommConfig()
        self.selections: list[Selection] = []

    def sizes(self) -> tuple[int, int]:
        """(n, N)."""
        return self.topo.n(), self.topo.N()

    # -- auto-dispatch ---------------------------------------------------
    def select(self, collective: str, payload_bytes: int, *,
               n: Optional[int] = None, N: Optional[int] = None,
               lead: Optional[int] = None) -> tuple[str, tuple]:
        """Rank auto-eligible registrations by measured-then-modelled cost.

        Returns (winning strategy, ((seconds, strategy), ...)).  Entries
        are skipped when they are lossy or layout-changing
        (``auto_ok=False``), have no cost model, or fail their
        divisibility precondition for ``lead``.

        Without a tuner (``cfg.tuner is None``) every cell is priced by
        the §3/§5 closed form and the ranking is ascending in seconds.
        With a tuner, each cell is first looked up in the measured timing
        table; MEASURED cells rank ahead of modelled ones (tier 0 before
        tier 1: a measured time beats a modelled one whatever their
        values), and unmeasured cells keep their closed-form price.  The
        source of the winning cost lands on the recorded
        ``Selection.source``, as in ``repro``.
        """
        strategy, ranking, _ = self._select(collective, payload_bytes,
                                            n=n, N=N, lead=lead)
        return strategy, ranking

    def _select(self, collective, payload_bytes, *, n=None, N=None,
                lead=None) -> tuple[str, tuple, str]:
        """``select``'s (strategy, ranking) and the winner's source."""
        if n is None or N is None:
            n, N = self.sizes()
        tuner = self.cfg.tuner
        table = []
        for e in iter_impls(collective):
            if not e.auto_ok or e.cost is None:
                continue
            if lead is not None and e.feasible is not None \
                    and not e.feasible(n, N, lead):
                continue
            measured = None if tuner is None else tuner.measured_cost(
                collective, e.strategy, n, N, payload_bytes)
            if measured is not None:
                table.append((0, float(measured), e.strategy))
            else:
                table.append((1, float(e.cost(n, N, payload_bytes,
                                              self.cfg)), e.strategy))
        if not table:
            raise ValueError(
                f"no auto-dispatchable implementation for {collective!r} "
                f"(payload {payload_bytes} B, n={n}, N={N}); registered "
                f"strategies: {strategies_for(collective)}")
        table.sort()
        ranking = tuple((t, s) for _, t, s in table)
        source = "measured" if table[0][0] == 0 else "model"
        return ranking[0][1], ranking, source

    @property
    def last_selection(self) -> Optional[Selection]:
        return self.selections[-1] if self.selections else None

    # -- parameter layout ------------------------------------------------
    def param_layout(self, strategy: Optional[str] = None) -> str:
        """Master-parameter layout kind the train step for ``strategy``
        (default: ``cfg.strategy``) expects."""
        from .layout import param_layout_kind
        return param_layout_kind(strategy or self.cfg.strategy)

    # -- dispatch core ---------------------------------------------------
    def _default_strategy(self, collective: str) -> str:
        if collective == "prefetch_allgather":
            # -1 is the blocking negative control of the prefetch
            return "blocking" if self.cfg.prefetch_blocks == -1 \
                else "lane_pipelined"
        s = self.cfg.strategy
        return s if s == "auto" or has_impl(collective, s) else "auto"

    def _dispatch(self, collective: str, x: Any, strategy: Optional[str],
                  **kw) -> Any:
        strategy = strategy or self._default_strategy(collective)
        if strategy == "auto":
            payload = _payload_bytes(x)
            strategy, ranking, source = self._select(collective, payload,
                                                     lead=_lead(x))
            if self.cfg.record_selections:
                self.selections.append(
                    Selection(collective, strategy, payload, ranking,
                              source))
        return get_impl(collective, strategy).fn(self, x, **kw)

    # -- the collective surface (paper §3, Listings 1-6 + Scan) ----------
    def allreduce(self, x, *, strategy: Optional[str] = None, **kw):
        """Sum over the whole (node × lane) communicator, on every process."""
        return self._dispatch("allreduce", x, strategy, **kw)

    def reduce_scatter(self, x, *, strategy: Optional[str] = None, **kw):
        """Reduce p·m rows; each process keeps its global-rank block of m."""
        return self._dispatch("reduce_scatter", x, strategy, **kw)

    def allgather(self, x, *, strategy: Optional[str] = None, **kw):
        """Concatenate every process's block in global-rank order."""
        return self._dispatch("allgather", x, strategy, **kw)

    def bcast(self, x, *, strategy: Optional[str] = None, **kw):
        """Broadcast the root process's buffer."""
        return self._dispatch("bcast", x, strategy, **kw)

    def alltoall(self, x, *, strategy: Optional[str] = None, **kw):
        """Personalized exchange: destination-rank blocks → source-rank."""
        return self._dispatch("alltoall", x, strategy, **kw)

    def reduce(self, x, *, strategy: Optional[str] = None, **kw):
        """Sum valid on the root process, zeros elsewhere."""
        return self._dispatch("reduce", x, strategy, **kw)

    def gather(self, x, *, strategy: Optional[str] = None, **kw):
        """All blocks on the root process in global-rank order, zeros
        elsewhere."""
        return self._dispatch("gather", x, strategy, **kw)

    def scatter(self, x, *, strategy: Optional[str] = None, **kw):
        """Each process receives its global-rank block of the root's
        buffer."""
        return self._dispatch("scatter", x, strategy, **kw)

    def scan(self, x, *, strategy: Optional[str] = None, **kw):
        """Inclusive prefix sum by consecutive global rank (MPI_Scan)."""
        return self._dispatch("scan", x, strategy, **kw)

    def moe_route(self, x, *, strategy: Optional[str] = None, **kw):
        """Token-routing alltoall; ROADMAP.md item 10 ports it."""
        return self._dispatch("moe_route", x, strategy or "lane", **kw)

    # -- composite training collectives ----------------------------------
    def grad_sync(self, grads, *, strategy: Optional[str] = None,
                  num_buckets: Optional[int] = None, **kw):
        """Synchronize (mean) a gradient tree over the communicator, IN
        PLACE: the leaves of ``grads`` are overwritten with the mean and
        the tree is returned.  ``num_buckets``: None = ``cfg.buckets``;
        0 = cost-model auto."""
        nb = self.cfg.buckets if num_buckets is None else num_buckets
        return self._dispatch("grad_sync", grads, strategy,
                              num_buckets=nb, **kw)

    def prefetch_allgather(self, shard, *, strategy: Optional[str] = None,
                           num_blocks: Optional[int] = None):
        """Re-gather a 1/p ZeRO-3 stripe to the full flat vector.

        Default strategy follows ``cfg.prefetch_blocks``: -1 dispatches
        to the monolithic ``"blocking"`` gather (the negative control),
        anything else to the §5 ``"lane_pipelined"`` AG(lane)→AG(node).
        """
        return self._dispatch("prefetch_allgather", shard, strategy,
                              num_blocks=num_blocks)

    def kv_splice(self, big, *, small, slot, batch_axis: int = 1,
                  strategy: Optional[str] = None, **kw):
        """Distribute a fresh batch-1 cache leaf ``small`` (computed on
        every process, the root's copy canonical) into global slot
        ``slot`` of the slot-sharded leaf ``big`` (this process's block of
        slots, in global-rank order, along ``batch_axis``), in place;
        returns ``big``.  Strategies: ``"lane"`` (default) or
        ``"native"``."""
        return self._dispatch("kv_splice", big, strategy or "lane",
                              small=small, slot=slot,
                              batch_axis=batch_axis, **kw)
