"""Autotune: snap f0 toward the nearest note of a fixed 54-note table
(a copy of `rvc_tpu/pitch/autotune.py`), vectorized numpy."""

from __future__ import annotations

import numpy as np

NOTE_TABLE = np.array([
    49.00, 51.91, 55.00, 58.27, 61.74, 65.41, 69.30, 73.42, 77.78, 82.41,
    87.31, 92.50, 98.00, 103.83, 110.00, 116.54, 123.47, 130.81, 138.59,
    146.83, 155.56, 164.81, 174.61, 185.00, 196.00, 207.65, 220.00, 233.08,
    246.94, 261.63, 277.18, 293.66, 311.13, 329.63, 349.23, 369.99, 392.00,
    415.30, 440.00, 466.16, 493.88, 523.25, 554.37, 587.33, 622.25, 659.25,
    698.46, 739.99, 783.99, 830.61, 880.00, 932.33, 987.77, 1046.50,
], dtype=np.float32)


def autotune_f0(f0: np.ndarray, strength: float = 1.0) -> np.ndarray:
    """Blend each voiced f0 toward its nearest table note by `strength`."""
    f0 = np.asarray(f0, dtype=np.float32)
    idx = np.abs(f0[:, None] - NOTE_TABLE[None, :]).argmin(axis=1)
    closest = NOTE_TABLE[idx]
    tuned = f0 + (closest - f0) * strength
    return np.where(f0 > 0, tuned, f0)


class Autotune:
    note_dict = NOTE_TABLE

    def autotune_f0(self, f0: np.ndarray, strength: float = 1.0) -> np.ndarray:
        return autotune_f0(f0, strength)
