"""Device-to-host reads a frame (`_device.host_reads` over the window, per
window frame): each one makes the host wait for the device."""

UNIT = "reads/frame"


def read(ctx):
    return ctx.host_reads / ctx.frames if ctx.frames else None
