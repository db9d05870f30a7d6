"""From a ``torch.profiler`` trace to the numbers the per-layer metrics
read.

:func:`events` takes the device operations (kernels, copies, fills) and
the host's events as (name, start s, end s) from the profiler (on the
card the CUDA calls that issue the operations; the harness records no
host operation there, which keeps the profiler's cost on the host low);
:func:`reduce` makes of them the traced window's busy seconds (the union
of the device's intervals), its device seconds by operation name and in
all, and its idle gaps by what the host was doing in each (the innermost
host event across the gap's middle, or none: "between CUDA calls").
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

Event = Tuple[str, float, float]
GAP_SAMPLE = 400  # the longest gaps that are labelled


def events(prof) -> Tuple[List[Event], List[Event]]:
    """(device events, host events) of a stopped profiler."""
    from torch._C._autograd import DeviceType

    dev: List[Event] = []
    host: List[Event] = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() * 1e-9
        end = start + e.duration_ns() * 1e-9
        (dev if e.device_type() == DeviceType.CUDA else host).append(
            (e.name(), start, end))
    return dev, host


def _union(intervals: Sequence[Tuple[float, float]]) -> List[List[float]]:
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce(dev: Sequence[Event], host: Sequence[Event]) -> Dict[str, object]:
    """``busy_s``, ``device_s`` (the sum of the device operations' times),
    ``op_s`` (by name) and ``gap_s`` (idle seconds by the host's
    operation), over the span from the first event to the last."""
    op_s: Dict[str, float] = defaultdict(float)
    for name, s, e in dev:
        op_s[name] += e - s
    merged = _union([(s, e) for _, s, e in dev])
    busy = sum(e - s for s, e in merged)
    everything = [(s, e) for _, s, e in dev] + [(s, e) for _, s, e in host]
    lo = min((s for s, _ in everything), default=0.0)
    hi = max((e for _, e in everything), default=0.0)
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    gap_s: Dict[str, float] = defaultdict(float)
    if host and gaps:
        names = [n for n, _, _ in host]
        starts = np.array([s for _, s, _ in host])
        ends = np.array([e for _, _, e in host])
        for g0, g1 in gaps[:GAP_SAMPLE]:
            mid = 0.5 * (g0 + g1)
            hit = np.nonzero((starts <= mid) & (ends >= mid))[0]
            label = (names[hit[np.argmax(starts[hit])]] if hit.size
                     else "between CUDA calls")
            gap_s[label] += g1 - g0
    return {"busy_s": busy, "device_s": sum(op_s.values()),
            "op_s": dict(op_s), "gap_s": dict(gap_s), "span_s": hi - lo}


def top(table: Dict[str, float], k: int = 10) -> List[List[object]]:
    return [[n, v] for n, v in sorted(table.items(),
                                      key=lambda kv: -kv[1])[:k]]
