"""Voice activity detection (a copy of `rvc_tpu/realtime/vad.py`).

The reference uses webrtcvad (C++). This ships an energy gate with an
adaptive noise floor behind the same interface, and uses webrtcvad when it
is installed.
"""

from __future__ import annotations

import numpy as np

try:
    import webrtcvad
except ImportError:
    webrtcvad = None


class VADProcessor:
    def __init__(self, sensitivity_mode: int = 3, sample_rate: int = 16000,
                 frame_duration_ms: int = 30):
        self.sample_rate = sample_rate
        self.frame_ms = frame_duration_ms
        self.frame_len = sample_rate * frame_duration_ms // 1000
        self.sensitivity = sensitivity_mode
        self._vad = webrtcvad.Vad(sensitivity_mode) if webrtcvad is not None else None
        # adaptive noise floor of the energy gate
        self._noise_rms = 1e-4

    def is_speech(self, audio: np.ndarray) -> bool:
        audio = np.asarray(audio, dtype=np.float32)
        if self._vad is not None:
            pcm = (np.clip(audio, -1, 1) * 32767).astype(np.int16).tobytes()
            n = self.frame_len * 2
            frames = [pcm[i: i + n] for i in range(0, len(pcm) - n + 1, n)]
            if not frames:
                return False
            votes = sum(self._vad.is_speech(f, self.sample_rate) for f in frames)
            return votes >= max(1, len(frames) // 3)
        # energy above the adaptive floor
        rms = float(np.sqrt(np.mean(audio ** 2)) + 1e-12)
        thresh_mult = {0: 2.0, 1: 3.0, 2: 4.5, 3: 6.0}.get(self.sensitivity, 4.0)
        speech = rms > thresh_mult * self._noise_rms
        if not speech:
            self._noise_rms = 0.95 * self._noise_rms + 0.05 * rms
        return speech
