"""What a `torch.profiler` slice of the window says about the device.

The slice is the host interval of the harness's `efbench.slice` annotation.
Device activity (kernels, copies, sets) is clipped to it; the device is busy
in the union of those intervals, and idle in the gaps between them, each gap
named by what the host was doing at its middle: the innermost harness
annotation and the innermost host operation there.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, NamedTuple, Tuple

SLICE = "efbench.slice"
MARK = "efbench."


class Interval(NamedTuple):
    start: int   # ns
    end: int
    name: str


class Slice(NamedTuple):
    window_s: float
    busy_s: float
    kernels: int                          # kernel launches on the device
    by_name: Dict[str, Tuple[int, float]]  # kernel or copy -> (count, seconds)
    gaps: List[Tuple[str, float]]          # longest idle gaps first


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def union_ns(iv: List[Tuple[int, int]]) -> Tuple[int, List[Tuple[int, int]]]:
    """Total length of the union of intervals, and the union itself."""
    out: List[Tuple[int, int]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return sum(e - s for s, e in out), out


def read_slice(events, n_gaps: int = 10) -> Slice:
    """Reduce the profiler's raw events (`prof.profiler.kineto_results.events()`)
    to the slice's numbers."""
    host, dev = [], []
    lo = hi = None
    for e in events:
        s, t, name = e.start_ns(), e.end_ns(), e.name()
        if name.startswith(MARK) and e.device_type().name != "CPU":
            continue            # an annotation's mirror on the device timeline
        if e.device_type().name == "CPU":
            if name == SLICE:
                lo, hi = s, t
            host.append(Interval(s, t, name))
        elif t > s:
            dev.append(Interval(s, t, name))
    if lo is None:
        raise RuntimeError("the trace holds no efbench.slice annotation")
    clipped = [Interval(max(d.start, lo), min(d.end, hi), d.name)
               for d in dev if d.end > lo and d.start < hi]
    busy, merged = union_ns([(d.start, d.end) for d in clipped])
    by_name: Dict[str, List] = defaultdict(lambda: [0, 0.0])
    for d in clipped:
        by_name[d.name][0] += 1
        by_name[d.name][1] += (d.end - d.start) * 1e-9
    kernels = sum(c for n, (c, _) in by_name.items() if not _is_copy(n))

    gaps, prev = [], lo
    for s, e in merged + [(hi, hi)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for s, e in gaps[:n_gaps]:
        mid = (s + e) // 2
        cover = [h for h in host if h.start <= mid <= h.end and h.name != SLICE]
        marks = [h for h in cover if h.name.startswith(MARK)]
        ops = [h for h in cover if not h.name.startswith(MARK)]
        inner = lambda hs: min(hs, key=lambda h: h.end - h.start).name if hs else "-"  # noqa: E731
        named.append((f"{inner(marks)} / {inner(ops)}", (e - s) * 1e-9))
    return Slice(window_s=(hi - lo) * 1e-9, busy_s=busy * 1e-9, kernels=kernels,
                 by_name={k: (v[0], v[1]) for k, v in by_name.items()}, gaps=named)
