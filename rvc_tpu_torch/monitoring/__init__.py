"""Training monitoring: the trackers and the voice-quality metrics
(counterpart of `rvc_tpu/monitoring`)."""

from rvc_tpu_torch.monitoring.tracker import (
    AimTracker,
    NullTracker,
    RollingMean,
    SimpleTracker,
    TensorBoardTracker,
    create_tracker,
    spectrogram_image,
)
from rvc_tpu_torch.monitoring.voice_metrics import (
    f0_accuracy,
    mel_cepstral_distortion,
    signal_to_noise_ratio,
    spectrogram_correlation,
)

__all__ = ["AimTracker", "NullTracker", "RollingMean", "SimpleTracker", "TensorBoardTracker",
           "create_tracker", "spectrogram_image", "f0_accuracy", "mel_cepstral_distortion",
           "spectrogram_correlation", "signal_to_noise_ratio"]
