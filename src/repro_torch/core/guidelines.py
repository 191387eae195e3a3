"""Self-consistent performance-guideline checking (paper §3/§4, refs [9,19]).

Counterpart of ``repro.core.guidelines``.  A guideline says: the native
implementation of a collective must not be slower than a correct mock-up
built from other collectives of the same library.  The paper benchmarks
MPI mock-ups against native MPI; the port times NCCL's (or gloo's) native
collective against the explicit full-lane decomposition on
``torch.distributed`` process groups.

`time_fn` uses the paper's measurement protocol: repetitions separated by
a synchronisation of the result's device (``torch.cuda.synchronize`` for
a CUDA result, nothing on the CPU, where the call has finished when it
returns), warmup discarded, report average and minimum (the paper reports
both; minimum is the headline number).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch import _tree

__all__ = ["time_fn", "time_fn_samples", "median_us", "GuidelineResult",
           "check_guideline"]


def block_until_ready(out):
    """Wait for every CUDA device that holds a tensor of ``out`` (a tensor
    or a tree of them); returns ``out``."""
    devices = {leaf.device for leaf in _tree.leaves(out)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return out


def time_fn_samples(fn: Callable, *args, reps: int = 30, warmup: int = 5,
                    fence: Optional[Callable] = None) -> list:
    """Raw per-repetition wall times in µs after ``warmup`` discarded
    calls — the paper's measurement protocol with the samples kept, so
    callers choose their own statistic (the tuning probe keys its cache
    on the MEDIAN: robust to the one-off scheduler hiccups that poison
    an average and, unlike the minimum, not a best-case fiction).
    ``fence``: called before each timed repetition, outside its time
    (the probe's barrier across processes)."""
    for _ in range(warmup):
        block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        if fence is not None:
            fence()
        t0 = time.perf_counter()
        block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e6)
    return times


def median_us(samples) -> float:
    """Median of a non-empty sample list (mean of the middle two)."""
    s = sorted(samples)
    if not s:
        raise ValueError("median of an empty sample list")
    m = len(s) // 2
    return s[m] if len(s) % 2 else (s[m - 1] + s[m]) / 2.0


def time_fn(fn: Callable, *args, reps: int = 30, warmup: int = 5):
    """Return (avg_us, min_us) over `reps` timed calls after `warmup`."""
    times = time_fn_samples(fn, *args, reps=reps, warmup=warmup)
    return sum(times) / len(times), min(times)


@dataclasses.dataclass
class GuidelineResult:
    name: str
    native_avg_us: float
    native_min_us: float
    mockup_avg_us: float
    mockup_min_us: float

    @property
    def violated(self) -> bool:
        """True ⇔ the mock-up beats the native (a library defect à la §4)."""
        return self.mockup_min_us < self.native_min_us

    @property
    def ratio(self) -> float:
        """native/mockup min-time ratio; >1 means guideline violation."""
        return self.native_min_us / max(self.mockup_min_us, 1e-9)

    def row(self) -> str:
        return (f"{self.name},{self.native_min_us:.2f},{self.mockup_min_us:.2f},"
                f"{self.ratio:.3f},{'VIOLATED' if self.violated else 'ok'}")


def check_guideline(name: str, native_fn: Callable, mockup_fn: Callable,
                    *args, reps: int = 30) -> GuidelineResult:
    na, nm = time_fn(native_fn, *args, reps=reps)
    ma, mm = time_fn(mockup_fn, *args, reps=reps)
    return GuidelineResult(name, na, nm, ma, mm)
