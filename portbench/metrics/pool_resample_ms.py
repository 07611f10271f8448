"""Host milliseconds a pool step spends resampling: the program's
RVC_TPU_TRACE=1 spans pool/resample_in (to 16 kHz, the circular buffers,
the gate volumes) and pool/resample_out (back to 48 kHz), read from their
record_function ranges in the device trace (`spans.reduce_spans`), over
the traced steps."""

from portbench import spans

spans.install()

SPANS = ("pool/resample_in", "pool/resample_out")


def read(ctx):
    return spans.host_ms(ctx, SPANS)
