"""Kernel launch calls a unit of traced work (a pool step, a training step):
the runtime and driver events named cudaLaunchKernel* or cuLaunchKernel*
in the device trace (`spans.reduce_spans`; copies and memsets are not
counted), over the traced units."""

from portbench import spans

spans.install()


def read(ctx):
    n = getattr(ctx.trace, "launches", 0)
    if not n or not ctx.snap.work:
        return None
    return n / ctx.snap.work
