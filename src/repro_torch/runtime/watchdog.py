"""Host-side per-pod progress watchdog -> the quorum's contributing mask.

Counterpart of ``repro.runtime.watchdog``, a copy (numpy only).

The paper's decomposition isolates the hop between nodes (the lane
allreduce on 1/n of the payload), which makes the pod the natural quorum
unit: one stalled pod delays exactly one lane participant, and
``runtime.straggler.quorum_mean`` takes a 0/1 contributing mask and
rescales the mean by the live count.  This module produces that mask.

On a fleet each pod's host bumps a progress counter (steps completed) in
a shared store (the ``torch.distributed`` store, say); the watchdog reads
them and declares any pod whose counter lags the step being formed by more
than ``deadline_steps`` non-contributing.  The training loop feeds the
heartbeats itself, from a :class:`~repro_torch.runtime.faults.FaultPlan`,
on every rank alike, so every rank derives the same mask without
communicating; the deadline arithmetic is the same.
"""
from __future__ import annotations

import numpy as np


class Watchdog:
    """Deadline-based liveness over per-pod progress heartbeats.

    deadline_steps: how many steps a pod's last heartbeat may lag the
        step being formed before the pod is masked out.  0 = strict
        (must have heartbeat at the current step).
    """

    def __init__(self, num_pods: int, deadline_steps: int = 0):
        if num_pods < 1:
            raise ValueError(f"num_pods must be >= 1, got {num_pods}")
        self.num_pods = num_pods
        self.deadline_steps = deadline_steps
        # -1 = never heard from; a pod that heartbeats step 0 is live
        self._last = np.full((num_pods,), -1, np.int64)

    def heartbeat(self, pod: int, step: int) -> None:
        """Record pod ``pod`` having COMPLETED (or reached) ``step``.

        Heartbeats are monotone: a late-arriving older heartbeat never
        rolls a pod's progress back.
        """
        if not 0 <= pod < self.num_pods:
            raise ValueError(f"pod {pod} outside [0, {self.num_pods})")
        self._last[pod] = max(self._last[pod], int(step))

    def mask(self, step: int) -> np.ndarray:
        """0/1 contributing mask (float32, shape (num_pods,)) for forming
        step ``step``: pod i contributes iff its last heartbeat is within
        ``deadline_steps`` of ``step``."""
        return (step - self._last <= self.deadline_steps) \
            .astype(np.float32)

    def live(self, step: int) -> tuple:
        """Sorted lane ranks contributing at ``step``."""
        return tuple(int(i) for i in np.nonzero(self.mask(step))[0])

    def stale(self, step: int) -> tuple:
        """Sorted lane ranks masked OUT at ``step``."""
        return tuple(int(i) for i in np.nonzero(self.mask(step) == 0)[0])
