"""Host time of the offline pipeline's own host steps, per converted second
of audio: the port's `RVC_TPU_TRACE=1` spans host/highpass, host/pad+upload,
fetch/materialize (the read-back, which waits for the chunk's device work)
and host/post, summed over the traced window."""

SPANS = ("host/highpass", "host/pad+upload", "fetch/materialize", "host/post")


def read(ctx):
    spans, audio_s = ctx.snap.spans, ctx.snap.work
    if not audio_s or not any(s in spans for s in SPANS):
        return None
    return 1e3 * sum(spans.get(s, 0.0) for s in SPANS) / audio_s
