"""The whole step's share of the card's bf16 peak: the model FLOP of the work
done in the traced window (the plain reference's products counted on meta
tensors, by the cell's driver: `drivers.song.offline_flop` per converted
chunk, `drivers.stream.block_flop` per stream and step,
`drivers.train.step_flop` per step, forward and backward) over the traced
window's length times 989 TFLOP/s, in percent."""

from portbench.work import PEAK_BF16


def read(ctx):
    if not ctx.snap.flop or not ctx.trace.window_s:
        return None
    return 100.0 * ctx.snap.flop / (ctx.trace.window_s * PEAK_BF16)
