"""The share of the traced window in which the card sat idle outside the
realtime engine's steps, in percent: (window - busy - the idle seconds
under the program's RVC_TPU_TRACE=1 span pool/step) / window. The idle
under pool/step is each device gap's overlap with the step's intervals on
the thread that launched the gap's next operation (`spans.reduce_spans`'
idle_s_in). What is left is the open loop's slack before the next block
is due: idle no change to the program removes at this rate. This plus
the idle under pool/step is `device_idle.stream`."""

from portbench import spans

spans.install()

SPAN = "pool/step"


def read(ctx):
    t = ctx.trace
    idle = getattr(t, "idle_s_in", {}).get(SPAN)
    if idle is None or not t.window_s:
        return None
    return 100.0 * (t.window_s - t.busy_s - idle) / t.window_s
