"""Spectral-gating noise reduction (the `noisereduce` capability used by
`VoiceConverter.convert_audio` via `clean_audio`/`clean_strength`,
`rvc/infer/infer.py:248`). A copy of `rvc_tpu/utils/noise.py`, host
numpy; the port imports nothing of `rvc_tpu`.

Stationary spectral gate: estimate a per-bin noise floor from the
quietest frames, build a soft mask over the STFT, attenuate below-floor
energy proportionally to `strength`.
"""

from __future__ import annotations

import numpy as np


def reduce_noise(
    audio: np.ndarray,
    sr: int,
    strength: float = 0.5,
    n_fft: int = 1024,
    hop: int = 256,
    noise_quantile: float = 0.1,
    gate_db: float = 6.0,
) -> np.ndarray:
    """Attenuate stationary background noise. strength in [0, 1]."""
    audio = np.asarray(audio, dtype=np.float32)
    if len(audio) < n_fft:
        return audio
    win = np.hanning(n_fft).astype(np.float64)
    pad = n_fft // 2
    a = np.pad(audio.astype(np.float64), (pad, pad), mode="reflect")
    n_frames = 1 + (len(a) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = a[idx] * win[None, :]
    spec = np.fft.rfft(frames, axis=1)
    mag = np.abs(spec)

    # noise statistics from the quietest frames (by total energy):
    # thresh = mean + 1.5*std per bin. A steady tonal bin has tiny std in
    # those frames, so its threshold hugs the tone and the mask stays ~1.
    energy = mag.sum(axis=1)
    k = max(1, int(len(energy) * max(noise_quantile, 0.05)))
    quiet = np.argsort(energy)[:k]
    noise_mean = mag[quiet].mean(axis=0, keepdims=True)
    noise_std = mag[quiet].std(axis=0, keepdims=True)
    thresh = noise_mean + 1.5 * noise_std
    ratio = np.clip(mag / np.maximum(thresh, 1e-12), 0.0, 1.0)
    mask = (1.0 - strength) + strength * ratio

    spec_clean = spec * mask
    frames_out = np.fft.irfft(spec_clean, n=n_fft, axis=1) * win[None, :]

    out = np.zeros(len(a))
    norm = np.zeros(len(a))
    for i in range(n_frames):
        s = i * hop
        out[s : s + n_fft] += frames_out[i]
        norm[s : s + n_fft] += win ** 2
    out = out / np.maximum(norm, 1e-8)
    return out[pad : pad + len(audio)].astype(np.float32)
