"""Host milliseconds a pool step spends dispatching: the program's
RVC_TPU_TRACE=1 span pool/dispatch (pad, upload, the block program's
launches), read from its record_function ranges in the device trace
(`spans.reduce_spans`), over the traced steps."""

from portbench import spans

spans.install()

SPANS = ("pool/dispatch",)


def read(ctx):
    return spans.host_ms(ctx, SPANS)
