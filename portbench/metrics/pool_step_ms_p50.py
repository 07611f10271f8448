"""The realtime engine's step: the median host-clock wall of
`VoiceChangerPool.process` per step (N streams' blocks, read-back and
SOLA included), over the window up to the end of the trace. A median of
steps, so it stands beside the tail, not in its place."""


def read(ctx):
    return ctx.snap.spans.get("pool/process")
