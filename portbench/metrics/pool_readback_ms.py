"""Host milliseconds a pool step spends reading back: the program's
RVC_TPU_TRACE=1 span pool/readback (the step's audio to the host, which
waits for the block program's device work), read from its record_function
ranges in the device trace (`spans.reduce_spans`), over the traced steps."""

from portbench import spans

spans.install()

SPANS = ("pool/readback",)


def read(ctx):
    return spans.host_ms(ctx, SPANS)
