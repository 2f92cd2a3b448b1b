"""Share of its roofline reached by `fuse_window` (K3,
`csrc/fuse_window.cu`, fuse's window pass): its launches' bounds over
their measured device time in the profiled slice, in %."""

from efbench.roofline import share

UNIT = "%"


def read(ctx):
    if ctx.slice is None:
        return None
    return share(ctx.slice.by_name, ctx.height, ctx.width, kernels=("fuse_window",))
