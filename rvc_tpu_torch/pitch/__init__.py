"""Pitch extraction (counterpart of `rvc_tpu/pitch`): `PitchExtractor`, one
facade over the neural extractors (rmvpe, crepe, crepe-tiny, fcpe; on the
facade's device) and the DSP ones (dio, harvest, pm; host numpy), and
hybrid[a+b+...] combinations; `autotune_f0` / `Autotune`."""

from rvc_tpu_torch.pitch.autotune import Autotune, autotune_f0
from rvc_tpu_torch.pitch.extractors import PitchExtractor

__all__ = ["PitchExtractor", "Autotune", "autotune_f0"]
