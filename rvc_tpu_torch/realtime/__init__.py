"""Realtime (streaming) voice conversion (counterpart of `rvc_tpu/realtime`):
the SOLA-aligned block engine (`core`: `Realtime`, `VoiceChanger`), the
multi-stream pool (`pool`), the servers (`server`, `webui`), the circular
buffer, the VAD and the post-processing FX chain (`fx`), which offline
conversion's `post_process` runs too. The convert buffer has a fixed
size, so every block runs the same shapes."""

from rvc_tpu_torch.realtime.buffer import circular_write
from rvc_tpu_torch.realtime.core import Realtime, VoiceChanger
from rvc_tpu_torch.realtime.fx import FXChain, build_fx_chain

__all__ = ["Realtime", "VoiceChanger", "circular_write", "FXChain", "build_fx_chain"]
