"""Share of an untraced frame's time in which the device is idle, in %:
1 - (device-busy ms a frame in the profiled slice: the union of its
kernel, copy and set intervals over its frames) / (ms a frame of the
untraced window).  The slice gives the device's work a frame, which the
profiler leaves as it is; its wall time it does not (each graph launch
costs the host more under the profiler), so the pace is the window's."""

UNIT = "%"


def read(ctx):
    if ctx.slice is None or not ctx.frames or ctx.untraced_ms_per_frame <= 0:
        return None
    busy_ms = ctx.slice.busy_s / ctx.slice_frames * 1e3
    return (1.0 - busy_ms / ctx.untraced_ms_per_frame) * 100.0
