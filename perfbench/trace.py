"""What a traced window's profile says, in numbers the readers take.

``summarize`` reads one ``torch.profiler`` session that covered the
traced steps inside a ``record_function(WINDOW)`` range, on one process:

  window_s      the range's length on the host clock
  busy_s        the time in which some operation ran on the device
                (kernels, copies and sets, their intervals merged)
  kernel_sum_s  the device operations' durations summed
  ranges        {annotation: the device seconds of the operations
                 launched inside it}, from the profiler's correlation of
                 each device operation to the host range that launched it
  kernels       [[name, launches, seconds], ...] by device operation name
  device_ops    the ten device operations that took most time
  idle_gaps     the ten host operations under which the device idled
                longest: each gap between device intervals is named by the
                innermost host operation running at its middle
"""
from __future__ import annotations

import bisect
import collections

import torch

WINDOW = "perfbench/window"
NAME_CHARS = 160


def _is_device(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA


def _annotation(e) -> bool:
    return bool(getattr(e, "is_user_annotation", False))


def summarize(prof) -> dict:
    events = list(prof.events())
    window = [e for e in events if e.name == WINDOW and not _is_device(e)]
    if len(window) != 1:
        raise RuntimeError(f"the profile holds {len(window)} '{WINDOW}' "
                           f"ranges, want 1")
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    host_names = {e.name for e in events if not _is_device(e)}
    host_ranges = {e.name for e in events if not _is_device(e)
                   and _annotation(e)} | {e.name for e in events
                                          if _is_device(e)
                                          and e.name in host_names}
    dev, by_name = [], collections.defaultdict(lambda: [0, 0.0])
    for e in events:
        if not _is_device(e) or _annotation(e) or e.name in host_ranges:
            continue
        a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if b <= a:
            continue
        dev.append((a, b))
        row = by_name[e.name]
        row[0] += 1
        row[1] += (b - a) / 1e6
    dev.sort()
    merged = []
    for a, b in dev:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)
    host = sorted(((e.time_range.start, e.time_range.end, e.name)
                   for e in events if not _is_device(e)
                   and e.name != WINDOW), key=lambda r: r[0])
    starts = [h[0] for h in host]
    idle = collections.Counter()
    for length, a, b in gaps[:400]:
        mid = (a + b) / 2
        name = "no host operation"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 4000, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        idle[name[:NAME_CHARS]] += length / 1e6
    ranges = collections.defaultdict(float)
    for row in prof.key_averages():
        if row.device_type != torch.autograd.DeviceType.CUDA \
                and row.key in host_ranges:
            ranges[row.key] += row.device_time_total / 1e6
    kernels = sorted(([name, c, s] for name, (c, s) in by_name.items()),
                     key=lambda r: -r[2])
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy / 1e6,
            "kernel_sum_s": sum(r[2] for r in kernels),
            "ranges": dict(ranges), "kernels": kernels,
            "device_ops": [[n[:NAME_CHARS], s] for n, _, s in kernels[:10]],
            "idle_gaps": [[n, s] for n, s in idle.most_common(10)]}
