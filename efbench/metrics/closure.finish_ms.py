"""Mean host time of a frame's finish (the engine's `finish` stopwatch span,
one finish a call in the steady state): the finish vector's read, the pose
log and, with loop closure on, the fern retrieval (a fern-resolution ICP
when a keyframe old enough matches), the global closure attempt and the
keyframe DB's update, over every window frame."""

UNIT = "ms"


def read(ctx):
    xs = ctx.finish_ms
    return sum(xs) / len(xs) if xs else None
