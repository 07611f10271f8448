"""Milliseconds the card sat idle inside RMVPE's recurrence, per converted
second of audio: each device gap's overlap with the program's
RVC_TPU_TRACE=1 span rmvpe/bigru on the thread that launched the gap's
next operation (`spans.reduce_spans`' idle_s_in: cuDNN's BiGRU steps
through a chunk's frames one launch group a frame), over the traced audio
seconds."""

from portbench import spans

spans.install()

SPAN = "rmvpe/bigru"


def read(ctx):
    idle = getattr(ctx.trace, "idle_s_in", {}).get(SPAN)
    if idle is None or not ctx.snap.work:
        return None
    return 1e3 * idle / ctx.snap.work
