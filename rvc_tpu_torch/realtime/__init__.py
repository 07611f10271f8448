"""Realtime conversion (counterpart of `rvc_tpu/realtime`). Only the
post-processing FX chain (`fx`) is ported so far; offline conversion's
`post_process` runs it."""

from rvc_tpu_torch.realtime.fx import FXChain, build_fx_chain

__all__ = ["FXChain", "build_fx_chain"]
