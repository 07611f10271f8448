"""Training monitoring: the trackers (counterpart of `rvc_tpu/monitoring`;
the voice-quality metrics are not ported)."""

from rvc_tpu_torch.monitoring.tracker import (
    AimTracker,
    NullTracker,
    RollingMean,
    SimpleTracker,
    TensorBoardTracker,
    create_tracker,
    spectrogram_image,
)

__all__ = ["AimTracker", "NullTracker", "RollingMean", "SimpleTracker", "TensorBoardTracker",
           "create_tracker", "spectrogram_image"]
