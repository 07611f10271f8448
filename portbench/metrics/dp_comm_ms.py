"""Device milliseconds a training step spends in the data axis's
collectives on rank 0: the kernels (NCCL's) launched inside the program's
RVC_TPU_TRACE=1 spans dp/all_reduce (the gradients, coalesced) and
dp/all_gather (ZeRO-1's updated slices), from rank 0's device trace, over
the traced steps. A collective's kernel waits on the slowest rank, so this
is transfer plus skew."""

SPANS = ("dp/all_reduce", "dp/all_gather")


def read(ctx):
    inside = ctx.trace.device_s_in
    if not ctx.snap.work or not any(s in inside for s in SPANS):
        return None
    return 1e3 * sum(inside.get(s, 0.0) for s in SPANS) / ctx.snap.work
