"""Share of its roofline reached by `splat_resolve` (K2,
`csrc/splat_resolve.cu`, the prediction's resolve pass): its launches'
bounds over their measured device time in the profiled slice, in %."""

from efbench.roofline import share

UNIT = "%"


def read(ctx):
    if ctx.slice is None:
        return None
    return share(ctx.slice.by_name, ctx.height, ctx.width, kernels=("splat_resolve",))
