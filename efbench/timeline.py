"""End-to-end numbers of a window from its timeline, on the host's clock.

A frame's latency runs from the start of its `process_frame` call to the end
of the call (or the `flush`) after which its pose is on the host: the call
in which the engine's pose log grew past it.  At pipeline depth d that is d
calls later, so a stall in any of them (a loop closure, a capture) is in the
latency of every frame waiting behind it.
"""

from __future__ import annotations

import math
from typing import List, Sequence


class Timeline:
    """Per-frame start times and the times their poses reached the host."""

    def __init__(self, t0: float, finished0: int):
        self.t0 = t0
        self.starts: List[float] = []
        self.ends: List[float] = []
        self._finished0 = finished0

    def started(self, t: float) -> None:
        self.starts.append(t)

    def call_ended(self, t: float, finished: int) -> None:
        """A call (or the flush) ended at `t` with `finished` poses logged in
        all: every window frame among them that had no end yet ends now."""
        done = min(finished - self._finished0, len(self.starts))
        while len(self.ends) < done:
            self.ends.append(t)

    def latencies_ms(self) -> List[float]:
        return [(e - s) * 1e3 for s, e in zip(self.starts, self.ends)]

    def fps(self, t_end: float) -> float:
        """Frames started in the window over the window's wall time."""
        return len(self.starts) / (t_end - self.t0)


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0..100) by linear interpolation between order
    statistics (numpy's default), over every value."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
