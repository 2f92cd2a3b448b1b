"""Share of the roofline reached by the hand-written kernels whose work is
fixed by their shapes (K2 splat_resolve, K3 fuse_window): the sum of their
launches' bounds over the sum of their measured device times in the
profiled slice, in %.  The per-kernel shares are printed on an earlier line.

Not covered: the tracker's six kernels (K1 steps, `tracker_update.cu`),
whose launches after a solve's exit return at once; a trace cannot tell the
live ones (`track.k1_ms` reads their time)."""

from efbench.roofline import share

UNIT = "%"


def read(ctx):
    if ctx.slice is None:
        return None
    return share(ctx.slice.by_name, ctx.height, ctx.width)
