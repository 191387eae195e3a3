"""TimingTable / Tuner — measured collective costs behind auto-dispatch.

Counterpart of ``repro.tuning.table``.  The paper's self-consistent
performance guidelines are only as honest as the numbers they are checked
against, and ``core/costmodel.py:HW`` runs on spec-sheet constants and
assumed latencies.  This module is the data layer of the fix:

  ``TimingTable``  measured medians keyed by
                   ``(collective, strategy, topology-signature,
                   payload-bucket)`` — the probe harness
                   (:mod:`repro_torch.tuning.probe`) fills it, the store
                   (:mod:`repro_torch.tuning.store`) persists it beside
                   the checkpoints, the fitter
                   (:mod:`repro_torch.tuning.fit`) regresses HW constants
                   from it.
  ``Tuner``        the ``CommConfig.tuner`` hook: per-candidate measured
                   cost in seconds, or None for an unmeasured cell so
                   ``LaneComm.select`` falls back to the closed-form
                   model (measure-once-then-commit: misses are recorded
                   so a later probe pass measures exactly what dispatch
                   asked for).

Payloads are keyed on the LOCAL per-process byte size — the quantity
``LaneComm._dispatch`` computes (``_payload_bytes``) — and bucketed to
the enclosing power of two; lookups between probed sizes interpolate
log-log, lookups beyond the probed ladder (past a 2× margin) miss.  The
topology signature folds in platform, device kind and the (n, N)
factorization, so a cache probed on one topology is stale on another:
signatures simply stop matching and dispatch falls back to the model.

The signature strings are ``repro``'s (platform ``"gpu"`` for CUDA and
``"cpu"``, as jax names them; the device kind is the name CUDA reports
for the card, the same string jax reports), so one cache file is
readable by both packages.  Everything here but the lazy signature
default is device-free.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Iterable, Optional

import torch

__all__ = [
    "TimingEntry", "TimingTable", "Tuner", "payload_bucket",
    "topology_signature", "parse_topology_signature",
]

_SIG_RE = re.compile(r"n(\d+)xN(\d+)$")


def payload_bucket(payload_bytes: int) -> int:
    """The enclosing power-of-two bucket of a payload byte size."""
    b = max(int(payload_bytes), 1)
    return 1 << (b - 1).bit_length()


def _device_fields(device) -> tuple:
    """(platform, device kind) of ``device`` as jax names them: ``("gpu",
    <the card's name>)`` for CUDA, ``("cpu", "cpu")`` for the CPU.  A
    CUDA device on a host without one raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available()"
                f" is False; pass device='cpu' to run on the CPU")
        return "gpu", torch.cuda.get_device_name(dev)
    if dev.type == "cpu":
        return "cpu", "cpu"
    raise ValueError(f"no topology signature for device type {dev.type!r}")


def topology_signature(n: int, N: int, *, platform: Optional[str] = None,
                       device_kind: Optional[str] = None,
                       device="cuda") -> str:
    """``<platform>/<device_kind>/n<n>xN<N>`` — the cache key's topology
    part.  platform/device_kind default to ``device``'s (read lazily, so
    pure table handling never touches a device); a cache probed on a
    different platform or (n, N) factorization therefore never matches
    and dispatch falls back to the closed-form model."""
    if platform is None or device_kind is None:
        p, dk = _device_fields(device)
        platform = platform or p
        device_kind = device_kind or dk
    dk = str(device_kind).replace(" ", "_").replace("/", "_")
    return f"{platform}/{dk}/n{int(n)}xN{int(N)}"


def parse_topology_signature(sig: str) -> tuple:
    """(n, N) back out of a signature (the fitter needs the geometry its
    design rows are built from)."""
    m = _SIG_RE.search(sig)
    if not m:
        raise ValueError(f"malformed topology signature {sig!r}")
    return int(m.group(1)), int(m.group(2))


@dataclasses.dataclass(frozen=True)
class TimingEntry:
    """One measured cell: a (collective, strategy) pair timed at one
    payload size on one topology.  ``payload_bytes`` is the probed LOCAL
    per-process size (== what ``LaneComm._dispatch`` sees);
    the cache key buckets it to the enclosing power of two."""
    collective: str
    strategy: str
    topo_sig: str
    payload_bytes: int
    median_us: float
    min_us: float
    reps: int

    @property
    def bucket(self) -> int:
        return payload_bucket(self.payload_bytes)

    @property
    def key(self) -> tuple:
        return (self.collective, self.strategy, self.topo_sig, self.bucket)


class TimingTable:
    """Measured medians keyed by (collective, strategy, topo_sig,
    payload_bucket).  ``put`` keeps the FIRST measurement of a cell
    (measure-once-then-commit — re-probing a committed cell would make
    two runs of the same cache rank differently); ``merge`` folds a
    freshly-probed table into a restored one under the same rule."""

    def __init__(self, entries: Iterable[TimingEntry] = ()):
        self._entries: dict = {}
        for e in entries:
            self.put(e)

    def __len__(self) -> int:
        return len(self._entries)

    def put(self, entry: TimingEntry) -> bool:
        """Insert one cell; returns False when the cell was already
        measured (measure-once)."""
        if entry.key in self._entries:
            return False
        self._entries[entry.key] = entry
        return True

    def get(self, collective: str, strategy: str, topo_sig: str,
            bucket: int) -> Optional[TimingEntry]:
        return self._entries.get((collective, strategy, topo_sig, bucket))

    def entries(self) -> tuple:
        """All cells, deterministically ordered by key."""
        return tuple(self._entries[k] for k in sorted(self._entries))

    def merge(self, other: "TimingTable") -> int:
        """Fold ``other`` in (existing cells win); returns cells added."""
        return sum(self.put(e) for e in other.entries())

    def signatures(self) -> tuple:
        return tuple(sorted({e.topo_sig for e in self._entries.values()}))

    # -- the lookup dispatch prices candidates with -----------------------
    def lookup_us(self, collective: str, strategy: str, topo_sig: str,
                  payload_bytes: int) -> Optional[float]:
        """Median µs for a payload, or None (unmeasured → model fallback).

        Exact probed sizes return their median; sizes between two probed
        points interpolate log-log (collective times are near power laws
        in payload, so log-log linear is the right family); sizes within
        a 2× margin beyond either end scale linearly in bytes off the
        nearest probed point; anything further out is a miss — a cache
        probed at KBs must not be trusted to price GBs.
        """
        pts = sorted(
            (e.payload_bytes, e.median_us)
            for e in self._entries.values()
            if e.collective == collective and e.strategy == strategy
            and e.topo_sig == topo_sig)
        if not pts:
            return None
        b = float(max(int(payload_bytes), 1))
        lo, hi = pts[0], pts[-1]
        if b < lo[0]:
            return lo[1] * b / lo[0] if b >= lo[0] / 2 else None
        if b > hi[0]:
            return hi[1] * b / hi[0] if b <= hi[0] * 2 else None
        for (b0, t0), (b1, t1) in zip(pts, pts[1:]):
            if b0 <= b <= b1:
                if b0 == b1 or b == b0:
                    return t0
                if b == b1:             # exact probed size: verbatim
                    return t1
                w = (math.log(b) - math.log(b0)) \
                    / (math.log(b1) - math.log(b0))
                return math.exp((1 - w) * math.log(max(t0, 1e-9))
                                + w * math.log(max(t1, 1e-9)))
        return pts[0][1]        # single point, b == its payload

    # -- canonical (de)serialization used by the store --------------------
    def to_doc(self) -> list:
        """Key-sorted list of plain dicts — canonical, so the JSON the
        store writes is byte-identical across save→load→save."""
        return [{"collective": e.collective, "strategy": e.strategy,
                 "topo_sig": e.topo_sig, "payload_bytes": e.payload_bytes,
                 "median_us": e.median_us, "min_us": e.min_us,
                 "reps": e.reps} for e in self.entries()]

    @classmethod
    def from_doc(cls, doc: list) -> "TimingTable":
        if not isinstance(doc, list):
            raise ValueError(f"timing-table doc must be a list, got "
                             f"{type(doc).__name__}")
        entries = []
        for i, row in enumerate(doc):
            try:
                entries.append(TimingEntry(
                    collective=str(row["collective"]),
                    strategy=str(row["strategy"]),
                    topo_sig=str(row["topo_sig"]),
                    payload_bytes=int(row["payload_bytes"]),
                    median_us=float(row["median_us"]),
                    min_us=float(row["min_us"]),
                    reps=int(row["reps"])))
            except (KeyError, TypeError, ValueError) as e:
                raise ValueError(f"timing-table row {i} malformed: {e}")
        return cls(entries)


class Tuner:
    """The ``CommConfig.tuner`` hook: measured cost per dispatch cell.

    ``measured_cost`` returns seconds from the timing table or None for
    an unmeasured cell — ``LaneComm.select`` falls back to the §3/§5
    closed form on None, and the miss is recorded on ``self.misses`` so
    a follow-up probe pass (the measure-once-then-commit loop's
    "measure" half) times exactly the cells dispatch actually asked
    for.  A table whose rows cannot be interpolated (a payload or time
    of 0 a hand-made table may hold) must never take dispatch down, so
    such a lookup is a miss too, as in ``repro``.

    platform/device_kind pin the signature side of the key at
    construction (None = read off ``device`` on first use, which raises
    for a CUDA device on a host without one); n/N arrive per query from
    the dispatching communicator, which is what makes a cache probed at
    one topology stale at another.
    """

    def __init__(self, table: TimingTable, *,
                 platform: Optional[str] = None,
                 device_kind: Optional[str] = None, device="cuda"):
        self.table = table
        self._platform = platform
        self._device_kind = device_kind
        self._device = device
        self.misses: list = []

    def signature(self, n: int, N: int) -> str:
        sig = topology_signature(n, N, platform=self._platform,
                                 device_kind=self._device_kind,
                                 device=self._device)
        if self._platform is None or self._device_kind is None:
            # pin what the lazy default resolved to, so every query of
            # this tuner keys identically
            head, _, _ = sig.rpartition("/")
            self._platform, self._device_kind = head.split("/", 1)
        return sig

    def measured_cost(self, collective: str, strategy: str, n: int, N: int,
                      payload_bytes: int) -> Optional[float]:
        """Seconds for one candidate cell, or None (unmeasured)."""
        sig = self.signature(n, N)
        try:
            us = self.table.lookup_us(collective, strategy, sig,
                                      payload_bytes)
        except (ValueError, ArithmeticError):
            return None         # a rotten cache must never crash dispatch
        if us is None:
            self.misses.append((collective, strategy, int(n), int(N),
                                int(payload_bytes)))
            return None
        return us * 1e-6
