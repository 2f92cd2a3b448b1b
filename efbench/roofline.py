"""The yardstick of the port's hand-written kernels: the card's peaks, each
kernel's symbol in a profiler trace, and the bytes and operations a launch
needs, computed from the shapes its caller passes.

Frozen copy of the counts in `chip_smoke.py` (`bound()`, the
`splat_resolve` and `fuse_window` entries of its kernel checks, as recounted
there for the H100); the program may change, this copy may not.

A launch's bound is the larger of bytes / peak bytes per second and
operations / peak float32 operations per second.  Only kernels whose work is
fixed by their shapes have a bound here: the tracker's steps and updates are
predicated on a device flag (an iteration after the solve's exit launches
and returns at once), and a trace does not say which launches were live.
They get one once the program reads each solve's exit iteration with the
frame's finish vector.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Optional, Tuple

# published peaks of one H100 SXM (data sheet, dense): HBM bytes/s and float32
# operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# kernel name in the trace -> the symbol of its `__global__` function
SYMBOLS: Dict[str, str] = {
    "icp_step": "icp_step_kernel",
    "rgb_residual": "rgb_residual_kernel",
    "rgb_step": "rgb_step_kernel",
    "so3_step": "so3_step_kernel",
    "so3_update": "so3_update_kernel",
    "gn_update": "gn_update_kernel",
    "splat_resolve": "splat_resolve_kernel",
    "fuse_window": "fuse_window_kernel",
    "gram_outer": "gram_kernel",
}

# the tracker's kernels (K1 and its loop bodies, csrc/odometry_steps.cu and
# csrc/tracker_update.cu)
TRACK = ("icp_step", "rgb_residual", "rgb_step", "so3_step", "so3_update", "gn_update")

F32 = 4


def kernel_of(trace_name: str) -> Optional[str]:
    """The kernel a trace's kernel name (demangled, or mangled with the
    symbol's length before it) belongs to, or None."""
    for k, sym in SYMBOLS.items():
        if (re.search(rf"(?<![A-Za-z0-9_]){sym}(?![A-Za-z0-9_])", trace_name)
                or f"{len(sym)}{sym}" in trace_name):
            return k
    return None


def bound_s(bytes_moved: float, ops: float) -> float:
    return max(bytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def launch_bound_s(kernel: str, H: int, W: int) -> Optional[float]:
    """Least time of one launch at an H x W image, or None where the
    kernel's work is not fixed by its shapes."""
    HW = H * W
    if kernel == "splat_resolve":
        # 13 channels read, 13 written; 25 taps x 2 passes x ~40 operations
        return bound_s(26 * HW * F32, 25 * 2 * 40.0 * HW)
    if kernel == "fuse_window":
        # 18 channels read, 16 written; 9 candidates x 45 + 60 + 9 x 13
        return bound_s(34 * HW * F32, (9 * 45.0 + 60 + 9 * 13) * HW)
    return None


def share(by_name: Dict[str, Tuple[int, float]], H: int, W: int,
          kernels: Optional[Iterable[str]] = None) -> Optional[float]:
    """Sum of the launches' bounds over the sum of their measured device
    times, in %, over the kernels of a trace (`name -> (launches, seconds)`)
    that have a bound (only those of `kernels`, where given); None where
    none of them ran."""
    want = None if kernels is None else set(kernels)
    bound = spent = 0.0
    for name, (n, sec) in by_name.items():
        k = kernel_of(name)
        b = launch_bound_s(k or "", H, W)
        if b is None or (want is not None and k not in want):
            continue
        bound += n * b
        spent += sec
    return bound / spent * 100.0 if spent > 0 else None
