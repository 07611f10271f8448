"""Device milliseconds per converted second of audio of the kernels
launched inside the range `portbench/f0_program`, which the benchmark opens
around the `Pipeline` instance's f0, from the device trace."""

RANGE = "portbench/f0_program"
WRAP = "pipeline.f0"


def read(ctx):
    s = ctx.trace.device_s_in.get(RANGE)
    if s is None or not ctx.snap.work:
        return None
    return 1e3 * s / ctx.snap.work
