"""Kernels launched on the device a frame in the profiled slice (replays
of the captured frame included; copies and sets not)."""

UNIT = "kernels/frame"


def read(ctx):
    if ctx.slice is None or not ctx.slice.kernels:
        return None
    return ctx.slice.kernels / ctx.slice_frames
