"""Device milliseconds per converted second of audio of the kernels
launched inside the program's RVC_TPU_TRACE=1 spans decoder/source and
decoder/stage (RefineGAN's sine template and decimation path, and its
upsampling stages), from the device trace."""

SPANS = ("decoder/source", "decoder/stage")


def read(ctx):
    inside = ctx.trace.device_s_in
    if not ctx.snap.work or not any(s in inside for s in SPANS):
        return None
    return 1e3 * sum(inside.get(s, 0.0) for s in SPANS) / ctx.snap.work
