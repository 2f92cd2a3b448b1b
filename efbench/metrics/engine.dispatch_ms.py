"""Mean host time of a frame's dispatch (the engine's `dispatch` stopwatch
span: static inputs loaded, the frame replayed or run, its finish copy
started), over the window's frames outside the profiled slice."""

UNIT = "ms"


def read(ctx):
    xs = ctx.dispatch_ms
    return sum(xs) / len(xs) if xs else None
