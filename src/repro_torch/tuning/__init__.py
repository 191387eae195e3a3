"""repro_torch.tuning — self-tuning dispatch: measured costs over spec sheets.

Counterpart of ``repro.tuning``.  The §3/§5 cost model's STRUCTURE is the
paper's analysis; its CONSTANTS (``core.costmodel.HW``) are spec-sheet
bandwidths and assumed latencies.  This subsystem closes the loop in
four parts:

  probe   (:mod:`.probe`)   time registered (collective, strategy)
                            cells on the started world → TimingTable
  store   (:mod:`.store`)   JSON+crc32 cache beside the checkpoints;
                            measure once, commit, restore on relaunch
                            (byte for byte ``repro``'s file)
  dispatch (:mod:`.table`)  ``Tuner`` behind ``CommConfig.tuner``:
                            measured cells outrank modelled ones in
                            ``LaneComm.select``; unmeasured cells fall
                            back to the closed form
  fit     (:mod:`.fit`)     least-squares HW constants from the table
                            (ranking forms unchanged, constants real),
                            with residuals in the guideline report
                            (:mod:`.guideline_report`)

``repro.tuning.backend`` (XLA flags) has no counterpart.
"""
from __future__ import annotations

from .fit import FitResult, design_row, fit_hw, predicted_us
from .guideline_report import DEFAULT_TOLERANCE, build_report
from .probe import (
    DEFAULT_LADDER, SMOKE_LADDER, probe_cells, probe_worklist,
    probeable_collectives,
)
from .store import (
    DEFAULT_CACHE_NAME, TuningCacheError, load_misses, load_timing_table,
    load_timing_table_or_none, save_timing_table,
)
from .table import (
    TimingEntry, TimingTable, Tuner, parse_topology_signature,
    payload_bucket, topology_signature,
)

__all__ = [
    # table / tuner
    "TimingEntry", "TimingTable", "Tuner", "payload_bucket",
    "topology_signature", "parse_topology_signature",
    # store
    "TuningCacheError", "save_timing_table", "load_timing_table",
    "load_timing_table_or_none", "load_misses", "DEFAULT_CACHE_NAME",
    # probe
    "probe_cells", "probe_worklist", "probeable_collectives",
    "DEFAULT_LADDER", "SMOKE_LADDER",
    # fit
    "FitResult", "fit_hw", "design_row", "predicted_us",
    # report
    "build_report", "DEFAULT_TOLERANCE",
]
