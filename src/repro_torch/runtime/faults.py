"""Deterministic fault injection for the training runtime.

Counterpart of ``repro.runtime.faults``, a copy: numpy only, so the plan
runs on the host between steps and inside the checkpoint writer thread.

On a fleet, faults come from outside: a pod's host stalls, a pod drops off
the network between nodes, a checkpoint write hits a flaky filesystem, a
committed file rots on disk.  None of that can be reproduced in a test, so
the training loop (``launch.train``) takes a :class:`FaultPlan` instead: a
seeded, declarative schedule of the same four fault classes, under which
every rung of the recovery ladder (quorum-masked DEGRADED steps, the
emergency checkpoint and elastic RESTART, the checkpoint retry and
verified fallback) runs deterministically on a world of CPU processes.

Fault kinds (``Fault.kind``):
  pod_slow      pod misses its progress heartbeat for steps [step, until]
                (inclusive); the watchdog masks it out of the quorum
  pod_lost      pod stops heartbeating at ``step`` and never returns;
                the health ladder escalates DEGRADED -> RESTART
  ckpt_io       the checkpoint save whose step == ``step`` raises OSError
                on its first ``count`` write attempts (transient I/O,
                absorbed by ``save_checkpoint``'s bounded retry)
  corrupt_leaf  AFTER the step-``step`` checkpoint commits, flip one byte
                of ``arr_<leaf>.npy``: the crc32 manifest check must
                refuse it and a restore falls back to the previous step

Spec grammar (one fault per ``;``-separated clause)::

    pod_slow@2-4:pod=1; pod_lost@5:pod=0; ckpt_io@6:count=2;
    corrupt_leaf@8:leaf=3

``kind@step[-until][:key=int,...]``.  Pod ids are lane ranks of the
CURRENT topology; after an elastic shrink the surviving pods renumber, so
an entry whose pod id falls off the smaller lane level is inert, like a
lost machine that is no longer part of the job.
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Callable, Optional, Sequence

import numpy as np

KINDS = ("pod_slow", "pod_lost", "ckpt_io", "corrupt_leaf")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault (see the kind table in the module docstring).

    until: last affected step for pod_slow (inclusive; defaults to
        ``step``); ignored by the other kinds (pod_lost is forever).
    pod: lane rank the pod_* kinds target.
    count: how many save attempts fail for ckpt_io (1 = first only).
    leaf: arr_<leaf>.npy index corrupt_leaf flips a byte of.
    """
    kind: str
    step: int
    until: int = -1
    pod: int = 0
    count: int = 1
    leaf: int = 0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"have {KINDS}")
        if self.until < 0:
            object.__setattr__(self, "until", self.step)
        if self.until < self.step:
            raise ValueError(f"fault window [{self.step}, {self.until}] "
                             f"is empty")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable schedule of :class:`Fault` entries.

    Query methods are pure functions of (plan, step): the training loop
    asks the same questions every step, and a resumed one asking about past
    steps gets the same answers (restart determinism).
    """
    faults: tuple = ()

    # -- construction -----------------------------------------------------
    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse the CLI grammar (module docstring); '' → empty plan."""
        faults = []
        for clause in spec.split(";"):
            clause = clause.strip()
            if not clause:
                continue
            head, _, tail = clause.partition(":")
            kind, _, window = head.partition("@")
            kind = kind.strip()
            if not window:
                raise ValueError(
                    f"fault clause {clause!r} missing '@step'")
            a, _, b = window.partition("-")
            kw = {"kind": kind, "step": int(a),
                  "until": int(b) if b else -1}
            for item in filter(None,
                               (s.strip() for s in tail.split(","))):
                k, _, v = item.partition("=")
                if k not in ("pod", "count", "leaf"):
                    raise ValueError(
                        f"unknown fault option {k!r} in {clause!r}")
                kw[k] = int(v)
            faults.append(Fault(**kw))
        return cls(tuple(faults))

    @classmethod
    def generate(cls, seed: int, steps: int, num_pods: int,
                 rate: float = 0.25) -> "FaultPlan":
        """Seeded random plan: a reproducible chaos-test schedule.

        Draws up to one fault per class over the run, placed uniformly
        in [1, steps); ``rate`` is the per-class inclusion probability.
        Deterministic in (seed, steps, num_pods, rate).
        """
        rng = np.random.default_rng(seed)
        faults = []
        if steps < 2:
            return cls(())
        for kind in KINDS:
            if rng.random() >= rate:
                continue
            s = int(rng.integers(1, steps))
            if kind == "pod_slow":
                faults.append(Fault(kind, s,
                                    until=min(steps - 1, s + int(
                                        rng.integers(1, 3))),
                                    pod=int(rng.integers(0, num_pods))))
            elif kind == "pod_lost":
                faults.append(Fault(kind, s,
                                    pod=int(rng.integers(0, num_pods))))
            elif kind == "ckpt_io":
                faults.append(Fault(kind, s,
                                    count=int(rng.integers(1, 3))))
            else:
                faults.append(Fault(kind, s, leaf=int(rng.integers(0, 4))))
        return cls(tuple(faults))

    # -- queries ----------------------------------------------------------
    def pods_down(self, step: int, num_pods: int) -> tuple:
        """Lane ranks NOT heartbeating at ``step`` (sorted, deduped).

        pod_slow covers its [step, until] window; pod_lost covers every
        step >= its start.  Entries targeting pods outside the current
        lane axis (``pod >= num_pods`` after an elastic shrink) are
        inert.
        """
        down = set()
        for f in self.faults:
            if f.pod >= num_pods:
                continue
            if f.kind == "pod_slow" and f.step <= step <= f.until:
                down.add(f.pod)
            elif f.kind == "pod_lost" and step >= f.step:
                down.add(f.pod)
        return tuple(sorted(down))

    def lost_pods(self, step: int, num_pods: int) -> tuple:
        """The PERMANENTLY lost subset of :meth:`pods_down` — what the
        RESTART replan must exclude (slow pods come back; lost ones
        don't)."""
        return tuple(sorted(
            f.pod for f in self.faults
            if f.kind == "pod_lost" and step >= f.step
            and f.pod < num_pods))

    def ckpt_failures(self, step: int) -> int:
        """How many save attempts of the step-``step`` checkpoint fail."""
        return sum(f.count for f in self.faults
                   if f.kind == "ckpt_io" and f.step == step)

    def ckpt_attempt_hook(self, step: int) -> Optional[Callable[[int], None]]:
        """An ``attempt_hook(attempt)`` for ``save_checkpoint``: raises
        OSError on the first ``ckpt_failures(step)`` attempts (0-based),
        then lets the write through.  None when no ckpt_io fault covers
        this step — the hot path stays hook-free."""
        fail = self.ckpt_failures(step)
        if not fail:
            return None

        def hook(attempt: int) -> None:
            if attempt < fail:
                raise OSError(
                    f"injected transient checkpoint I/O error "
                    f"(step {step}, attempt {attempt + 1}/{fail} failing)")
        return hook

    def corrupt_at(self, step: int) -> Optional[int]:
        """arr index to corrupt after the step-``step`` commit, or None."""
        for f in self.faults:
            if f.kind == "corrupt_leaf" and f.step == step:
                return f.leaf
        return None

    def __bool__(self):
        return bool(self.faults)


def corrupt_leaf_file(ckpt_dir: str, step: int, leaf: int) -> pathlib.Path:
    """Flip the last byte of ``step_<step>/arr_<leaf>.npy`` in place.

    The .npy header stays intact, so np.load still succeeds — only the
    manifest crc32 can tell.  (Flipping the LAST byte also corrupts the
    actual array data, not padding: np.save writes the raw buffer last.)
    Returns the corrupted path; raises FileNotFoundError when the leaf
    does not exist (a plan targeting a leaf index past the tree is a
    test bug worth failing loudly on).
    """
    p = pathlib.Path(ckpt_dir) / f"step_{step}" / f"arr_{leaf}.npy"
    raw = bytearray(p.read_bytes())
    if not raw:
        raise ValueError(f"{p} is empty")
    raw[-1] ^= 0xFF
    p.write_bytes(bytes(raw))
    return p


def parse_fault_plan(spec: str) -> FaultPlan:
    """CLI convenience alias: '' → empty plan, else the spec grammar."""
    return FaultPlan.parse(spec)
