"""RefineGAN's upsampling stages' share of their roofline: the sum of each
stage call's bound, max(FLOP / 67 TFLOP/s, bytes / 3.35 TB/s) from its
input's and skip tap's shapes (`drivers.longform_refinegan.stage_work`;
the float32 peak: the decoder runs float32 with TF32 off), over the device
time of the kernels launched inside the program's RVC_TPU_TRACE=1 span
decoder/stage, in percent. The benchmark wraps the program's stage
function (`refine_stage`) to see each call's shapes."""

from portbench import work

RANGE = "portbench/refine_stage"
WRAP = "rvc_tpu_torch.models.generators_extra.refine_stage"
SPAN = "decoder/stage"


def observe(acc, x, skip, rate, *args, **kwargs):
    from portbench.drivers.longform_refinegan import stage_work

    B, T, C = x.shape
    flop, nbytes = stage_work(B, T, C, rate, skip.shape[1])
    acc["bound_s"] = acc.get("bound_s", 0.0) + work.bound_s(flop, nbytes, work.PEAK_F32)


def read(ctx):
    s = ctx.trace.device_s_in.get(SPAN)
    bound = ctx.acc.get(RANGE, {}).get("bound_s")
    if not s or not bound:
        return None
    return 100.0 * bound / s
