"""Host milliseconds a pool step spends in SOLA: the program's
RVC_TPU_TRACE=1 span pool/sola (every stream's alignment and crossfade),
read from its record_function ranges in the device trace
(`spans.reduce_spans`), over the traced steps."""

from portbench import spans

spans.install()

SPANS = ("pool/sola",)


def read(ctx):
    return spans.host_ms(ctx, SPANS)
