"""The decoder's ResBlock stages' share of their roofline: the sum of each
stage call's bound, max(FLOP / 989 TFLOP/s, bytes / 3.35 TB/s) from its
input's shape and the stage's weights (`work.resblock_stage`), over the
device time of the kernels launched inside the range `portbench/resblocks`
that the benchmark opens around the program's stage function (forward
only), in percent."""

from portbench import work

RANGE = "portbench/resblocks"
WRAP = "rvc_tpu_torch.models.generators._stage_resblocks"


def observe(acc, x, blocks, kernel_sizes, dilations):
    B, T, C = x.shape
    flop, nbytes = work.resblock_stage(B, T, C, kernel_sizes, dilations)
    acc["bound_s"] = acc.get("bound_s", 0.0) + work.bound_s(flop, nbytes)


def read(ctx):
    s = ctx.trace.device_s_in.get(RANGE)
    bound = ctx.acc.get(RANGE, {}).get("bound_s")
    if not s or not bound:
        return None
    return 100.0 * bound / s
