"""Device milliseconds per converted second of audio of the kernels
launched inside the program's RVC_TPU_TRACE=1 span decoder/source:
RefineGAN's sine template, its merge and `pre_conv`, and the decimation
path (the Kaiser-windowed sinc lowpasses, 257 to 1,537 taps, depthwise,
and the strided downsampling convolutions), from the device trace."""

SPAN = "decoder/source"


def read(ctx):
    s = ctx.trace.device_s_in.get(SPAN)
    if s is None or not ctx.snap.work:
        return None
    return 1e3 * s / ctx.snap.work
