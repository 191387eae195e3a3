"""Run-health state machine: HEALTHY -> DEGRADED -> RESTART.

Counterpart of ``repro.runtime.health``, a copy (numpy only); its log
lines are ``repro``'s text.

The training loop's recovery ladder (``launch.train``) has three rungs:

  HEALTHY    every pod heartbeating: full-quorum steps, bit-identical to
             a run with no fault machinery at all
  DEGRADED   some pod(s) masked out of the quorum: steps proceed with
             ``quorum_mean``-rescaled gradients, the dropped
             (seed, step)-keyed rows are logged for replay, and a
             bounded-staleness clock ticks per stale pod
  RESTART    a pod exceeded the staleness bound (or the strategy cannot
             degrade): emergency checkpoint, then a new topology
             without it

The state is a pure function of the observed mask history, so a resumed
run replaying the same fault plan reaches the same transitions at the
same steps, and so does every rank of a world: each keeps the same
``events``, and the training loop lets only its lead rank print them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

HEALTHY = "HEALTHY"
DEGRADED = "DEGRADED"
RESTART = "RESTART"


@dataclasses.dataclass(frozen=True)
class HealthEvent:
    """One state transition: at forming ``step``, ``old`` → ``new``
    because of ``reason`` (human-readable)."""
    step: int
    old: str
    new: str
    reason: str


class HealthMonitor:
    """Fold per-step contributing masks into the ladder state.

    staleness_limit: K — consecutive masked steps a pod may accumulate
        while the run is DEGRADED before escalating to RESTART.  The
        bound is per pod and resets the moment the pod heartbeats again
        (a slow pod that recovers never triggers a restart).
    can_degrade: False when the active grad-sync strategy has no quorum
        path (every non-``lane_quorum`` strategy) — any masked pod then
        escalates straight to RESTART, because a step simply cannot be
        formed without it.
    log: print-like sink for transition lines (None = silent).
    """

    def __init__(self, num_pods: int, staleness_limit: int = 2,
                 can_degrade: bool = True,
                 log: Optional[Callable[[str], None]] = print):
        self.num_pods = num_pods
        self.staleness_limit = max(int(staleness_limit), 1)
        self.can_degrade = can_degrade
        self._log = log
        self.state = HEALTHY
        self.events: list[HealthEvent] = []
        self._stale_streak = np.zeros((num_pods,), np.int64)

    # -- core -------------------------------------------------------------
    def observe(self, step: int, mask) -> str:
        """Fold the mask for forming step ``step``; returns the new state.

        RESTART is terminal for this attempt: the training loop is
        expected to emergency-save, re-plan around :meth:`restart_pods`,
        and build a fresh monitor for the shrunken mesh.
        """
        if self.state == RESTART:
            return self.state
        m = np.asarray(mask)
        if m.shape != (self.num_pods,):
            raise ValueError(
                f"mask shape {m.shape} != ({self.num_pods},)")
        stale = m == 0
        self._stale_streak = np.where(stale, self._stale_streak + 1, 0)
        if not stale.any():
            self._to(HEALTHY, step, "all pods heartbeating")
            return self.state
        who = [int(i) for i in np.nonzero(stale)[0]]
        if not self.can_degrade:
            self._to(RESTART, step,
                     f"pods {who} stale and strategy cannot degrade "
                     f"(no quorum grad-sync)")
        elif int(self._stale_streak.max()) > self.staleness_limit:
            worst = [int(i) for i in
                     np.nonzero(self._stale_streak
                                > self.staleness_limit)[0]]
            self._to(RESTART, step,
                     f"pods {worst} exceeded staleness bound "
                     f"K={self.staleness_limit}")
        else:
            self._to(DEGRADED, step,
                     f"pods {who} masked (streak "
                     f"{int(self._stale_streak.max())}/"
                     f"{self.staleness_limit})")
        return self.state

    def restart_pods(self) -> tuple:
        """Lane ranks whose staleness triggered (or outlived) the RESTART
        — the pods the elastic replan must exclude."""
        return tuple(int(i) for i in
                     np.nonzero(self._stale_streak > 0)[0])

    # -- internals --------------------------------------------------------
    def _to(self, new: str, step: int, reason: str) -> None:
        if new == self.state:
            return
        ev = HealthEvent(step, self.state, new, reason)
        self.events.append(ev)
        self.state = new
        if self._log is not None:
            self._log(f"health: step {step}: {ev.old} -> {ev.new} "
                      f"({reason})")
