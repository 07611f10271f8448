"""Host milliseconds a training step spends in its optimizer updates: the
program's RVC_TPU_TRACE=1 span optim/adamw (G's update and each of D's:
the per-tensor AdamW loops), read from its record_function ranges in the
device trace (`spans.reduce_spans`), over the traced steps."""

from portbench import spans

spans.install()

SPANS = ("optim/adamw",)


def read(ctx):
    return spans.host_ms(ctx, SPANS)
