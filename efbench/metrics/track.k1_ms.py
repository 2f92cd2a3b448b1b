"""Device ms a frame in the tracker's kernels (so3_step, icp_step,
rgb_residual, rgb_step, so3_update, gn_update), by kernel name in the
profiled slice."""

from efbench.roofline import TRACK, kernel_of

UNIT = "ms"


def read(ctx):
    if ctx.slice is None:
        return None
    s = sum(sec for name, (_, sec) in ctx.slice.by_name.items()
            if kernel_of(name) in TRACK)
    return s / ctx.slice_frames * 1e3 if s > 0 else None
