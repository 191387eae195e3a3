"""Probe harness: time registered (collective, strategy) cells in place.

Counterpart of ``repro.tuning.probe``.  Walks the
:mod:`repro_torch.comm` registry — the probe grid IS the dispatch grid:
exactly the probe-eligible cells (``ImplEntry.probe_eligible``: the
auto-ranked costed set, plus cells that opt in with ``probe_ok=True``
such as the blocking prefetch negative control) — and times each one on
the started ``torch.distributed`` world at a ladder of payload sizes,
producing :class:`~repro_torch.tuning.table.TimingTable` entries keyed
the way dispatch will look them up (LOCAL per-process payload bytes, the
``LaneComm._payload_bytes`` quantity).

Every process of the topology runs the same calls; each passes its own
seeded block of ``local_elems`` f32 elements (``repro`` passes each chip
its block of one seeded global array under ``shard_map``).  Measurement
reuses the guideline discipline of :mod:`repro_torch.core.guidelines`:
warmup discarded, each repetition's result synchronised on its device.
Where ``repro`` times one SPMD program, here every process times its own
call, and processes that keyed dispatch on their own medians would pick
different strategies and deadlock in the collectives.  So every
repetition starts behind a fence over ``group`` (the device synchronised,
then a host all-reduce), and the per-repetition sample vectors are
all-reduced with MAX over ``group`` before the median and the minimum are
taken: the slowest process's time is the collective's time, and every
process stores bit-identical entries.

Cells already present in the table are skipped — the "once" half of
measure-once-then-commit: a run restoring its cache re-probes only what
it has never measured (e.g. after an elastic restart changed (n, N) and
the old signatures went stale).  ``probe_worklist`` drives the same
machinery from a ``Tuner.misses`` list: payloads dispatch actually asked
for but the cache could not answer.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.comm import CommConfig, LaneComm, get_impl, has_impl, \
    iter_impls
from repro_torch.core.guidelines import block_until_ready, median_us, \
    time_fn_samples

from .table import TimingEntry, TimingTable, payload_bucket, \
    topology_signature

__all__ = ["probe_cells", "probe_worklist", "probeable_collectives",
           "DEFAULT_LADDER", "SMOKE_LADDER"]

# local per-process payload bytes; the non-smoke top rung (2 MiB) is
# repro's full gradsync bench's per-chip stripe, the 32 KiB rung its
# smoke one
DEFAULT_LADDER = (1 << 12, 1 << 15, 1 << 18, 1 << 21)
SMOKE_LADDER = (1 << 12, 1 << 15, 1 << 18)

# the collectives with a uniform tensor -> tensor call shape, repro's
# probeable set
_PROBEABLE = ("grad_sync", "allreduce", "allgather", "reduce_scatter",
              "prefetch_allgather")


def probeable_collectives() -> tuple:
    """The collectives this harness knows how to drive (a subset of the
    registry chosen for having a uniform tensor→tensor call shape)."""
    return _PROBEABLE


def _round_local_elems(local_bytes: int, p: int) -> int:
    """Round the per-process payload up to a p² multiple of elements so
    every lane/node split divides evenly (the same divisibility
    dispatch's feasible() gates on)."""
    unit = p * p
    return max(unit, (local_bytes // 4 + unit - 1) // unit * unit)


def _group_device(group) -> torch.device:
    """Where a tensor for a collective over ``group`` lives."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _fence(group, dev: torch.device, x) -> None:
    """Every process of ``group`` at this point, its device idle."""
    block_until_ready(x)
    t = torch.zeros(1, device=dev)
    dist.all_reduce(t, group=group)
    block_until_ready(t)


def _probe_one(topo, e, local_bytes: int, *, table: TimingTable, sig: str,
               cfg: CommConfig, device: torch.device, group, reps: int,
               warmup: int, verbose: bool) -> None:
    """Measure one cell at one payload into ``table`` (idempotent:
    measured and infeasible cells are skipped, the same on every
    process)."""
    n, N = topo.sizes()
    p = max(n * N, 1)
    local_elems = _round_local_elems(local_bytes, p)
    payload = local_elems * 4
    if e.feasible is not None and not e.feasible(n, N, local_elems):
        return
    if table.get(e.collective, e.strategy, sig,
                 payload_bucket(payload)) is not None:
        return                  # measured once already — committed
    comm = LaneComm(topo, cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(topo.global_rank())     # seeded payloads, per protocol
    x = torch.randn(local_elems, generator=gen, device=device)
    gdev = _group_device(group)
    call = getattr(comm, e.collective)
    samples = time_fn_samples(lambda: call(x, strategy=e.strategy),
                              reps=reps, warmup=warmup,
                              fence=lambda: _fence(group, gdev, x))
    del x
    worst = torch.tensor(samples, dtype=torch.float64, device=gdev)
    dist.all_reduce(worst, op=dist.ReduceOp.MAX, group=group)
    samples = worst.tolist()
    entry = TimingEntry(e.collective, e.strategy, sig, payload,
                        median_us(samples), min(samples), reps)
    table.put(entry)
    if verbose:
        print(f"probe {e.collective:14s} {e.strategy:15s} "
              f"{payload:>9d}B  median={entry.median_us:9.1f}us"
              f"  min={entry.min_us:9.1f}us", flush=True)


def _context(topo, device, group, verbose):
    n, N = topo.sizes()
    return dict(sig=topology_signature(n, N, device=device),
                cfg=CommConfig(record_selections=False),
                device=torch.device(device),
                group=topo.group if group is None else group,
                verbose=verbose and topo.global_rank() == 0)


def probe_cells(topo, *, device="cuda", group=None,
                collectives: Optional[tuple] = None,
                ladder: Optional[tuple] = None, reps: int = 5,
                warmup: int = 2, table: Optional[TimingTable] = None,
                verbose: bool = True) -> TimingTable:
    """Time every probe-eligible registered cell of ``collectives`` at
    each ``ladder`` payload (local per-process bytes) on ``topo``, with
    the payloads on ``device``, into ``table`` (fresh one by default).
    Every process of ``group`` (default: the topology's whole
    communicator; the job's processes where several replicas of the
    topology must agree) makes the same call and gets the same table.
    Already-measured cells are skipped (measure-once); infeasible cells
    (divisibility) are skipped exactly as dispatch would skip them.
    Returns the table; a failing cell raises."""
    if collectives is None:
        collectives = ("grad_sync", "allreduce", "prefetch_allgather")
    if ladder is None:
        ladder = DEFAULT_LADDER
    if table is None:
        table = TimingTable()
    ctx = _context(topo, device, group, verbose)
    for coll in collectives:
        if coll not in _PROBEABLE:
            raise ValueError(
                f"don't know how to probe {coll!r}; probeable: "
                f"{probeable_collectives()}")
        for e in iter_impls(coll):
            if not e.probe_eligible:
                continue
            for local_bytes in ladder:
                _probe_one(topo, e, local_bytes, table=table, reps=reps,
                           warmup=warmup, **ctx)
    return table


def probe_worklist(topo, misses, *, table: TimingTable, device="cuda",
                   group=None, reps: int = 5, warmup: int = 2,
                   verbose: bool = True) -> int:
    """Probe exactly the cells a :class:`~repro_torch.tuning.table.Tuner`
    recorded as cache misses — ``(collective, strategy, n, N,
    payload_bytes)`` tuples, the payloads dispatch actually asked for.

    Misses recorded at a different topology than ``topo``'s are skipped
    (they cannot be measured here), as are collectives the harness cannot
    drive.  Returns the number of cells probed."""
    n, N = topo.sizes()
    ctx = _context(topo, device, group, verbose)
    before = len(table)
    for coll, strategy, mn, mN, payload_bytes in dict.fromkeys(
            tuple(m) for m in misses):
        if (int(mn), int(mN)) != (n, N):
            continue            # stale topology — not measurable here
        if coll not in _PROBEABLE or not has_impl(coll, strategy):
            continue
        _probe_one(topo, get_impl(coll, strategy), int(payload_bytes),
                   table=table, reps=reps, warmup=warmup, **ctx)
    return len(table) - before
