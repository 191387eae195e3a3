"""The collective-implementation registry behind :class:`~repro_torch.comm.LaneComm`.

Counterpart of ``repro.comm.registry``, the same table and rules.

The paper's decomposition gives every collective a *family* of correct
implementations (native one-shot, full-lane mock-up, §5 pipelined, …).
Each implementation is a one-decorator registration::

    @register_impl("allreduce", "lane_pipelined",
                   cost=cost_pipelined_allreduce)
    def _impl(comm, x, **kw): ...

and the dispatcher resolves ``(collective, strategy)`` through the table.
The optional ``cost`` callable — ``cost(n, N, payload_bytes, cfg) ->
seconds`` — is what makes the paper's self-consistent performance
guidelines *executable*: ``strategy="auto"`` ranks every auto-eligible
registration with the §3/§5 cost model and picks the cheapest.

Error messages and documentation derive the valid-strategy lists from
this table (never from a hard-coded tuple), so a new registration is
self-documenting.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

__all__ = [
    "ImplEntry", "register_impl", "get_impl", "has_impl",
    "strategies_for", "registered_collectives", "iter_impls",
]


@dataclasses.dataclass(frozen=True)
class ImplEntry:
    """One registered implementation of one collective.

    cost: ``(n, N, payload_bytes, cfg) -> seconds`` under the §3/§5 cost
        model (n = processes per node, N = nodes).  Entries without a
        cost are never auto-selected.
    auto_ok: eligible for ``strategy="auto"``.  False for lossy
        (``lane_int8``) or layout-changing (``lane_zero1``/``lane_zero3``)
        implementations whose results are not interchangeable with the
        exact full-payload ones.
    feasible: ``(n, N, lead) -> bool`` — divisibility precondition on the
        leading payload dimension; auto skips infeasible entries instead
        of tracing into their ValueError.
    probe_ok: eligibility for the measured-cost probe sweep,
        INDEPENDENT of auto-eligibility.  None (default) falls back to
        the auto rule (auto_ok and priced); True forces probing of cells
        that can never win auto dispatch but whose measured time is
        still wanted (the blocking prefetch negative control); False
        excludes a priced cell from the sweep.
    """
    collective: str
    strategy: str
    fn: Callable
    cost: Optional[Callable] = None
    auto_ok: bool = True
    feasible: Optional[Callable] = None
    probe_ok: Optional[bool] = None

    @property
    def probe_eligible(self) -> bool:
        """Should the timing probe measure this cell?"""
        if self.probe_ok is not None:
            return self.probe_ok
        return self.auto_ok and self.cost is not None


_REGISTRY: dict[str, dict[str, ImplEntry]] = {}


def register_impl(collective: str, strategy: str, *,
                  cost: Optional[Callable] = None, auto_ok: bool = True,
                  feasible: Optional[Callable] = None,
                  probe_ok: Optional[bool] = None,
                  override: bool = False) -> Callable:
    """Decorator: register ``fn(comm, payload, **kw)`` for a collective.

    Re-registering the same (collective, strategy) raises unless
    ``override=True`` — silent shadowing is how dispatch tables rot.
    """
    def deco(fn):
        table = _REGISTRY.setdefault(collective, {})
        if strategy in table and not override:
            raise ValueError(
                f"{collective!r} strategy {strategy!r} already registered "
                f"(by {table[strategy].fn.__module__}); pass override=True "
                f"to replace it")
        table[strategy] = ImplEntry(collective, strategy, fn, cost=cost,
                                    auto_ok=auto_ok, feasible=feasible,
                                    probe_ok=probe_ok)
        return fn
    return deco


def get_impl(collective: str, strategy: str) -> ImplEntry:
    """Resolve one registration; unknown names list what IS registered."""
    table = _REGISTRY.get(collective)
    if not table:
        raise ValueError(
            f"no implementations registered for collective {collective!r}; "
            f"registered collectives: {registered_collectives()}")
    if strategy not in table:
        raise ValueError(
            f"unknown strategy {strategy!r} for collective {collective!r}; "
            f"registered strategies: {strategies_for(collective)}")
    return table[strategy]


def has_impl(collective: str, strategy: str) -> bool:
    return strategy in _REGISTRY.get(collective, {})


def strategies_for(collective: str) -> tuple[str, ...]:
    """Registered strategy names for one collective, registration order."""
    return tuple(_REGISTRY.get(collective, {}))


def registered_collectives() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def iter_impls(collective: str) -> tuple[ImplEntry, ...]:
    return tuple(_REGISTRY.get(collective, {}).values())
