"""Host milliseconds a training step spends converting K1/K2's weights: the
program's RVC_TPU_TRACE=1 span kernels/convert_weights (a miss of
`ops.kernels.resblock.cached`: the weights changed since the last call),
read from its record_function ranges in the device trace
(`spans.reduce_spans`), over the traced steps. A program that opens
train/step but converted nothing in the window reads 0."""

from portbench import spans

spans.install()

SPANS = ("kernels/convert_weights",)


def read(ctx):
    if "train/step" in getattr(ctx.trace, "host_s_in", {}) and ctx.snap.work:
        return spans.host_ms(ctx, SPANS) or 0.0
    return spans.host_ms(ctx, SPANS)
