"""STFT / log-mel front end (counterpart of `rvc_tpu/ops/stft.py`).

`log_mel_spectrogram` is the plain PyTorch version of kernel K4
(`ops/kernels/melspec.py`): RMVPE's center=True log-mel with a periodic
Hann window, an HTK mel scale with Slaney area normalisation and
log(clamp 1e-5). `stft` is the complex STFT under it, which FCPE's
front end also takes (center=False). The mel filterbank is a numpy copy
of the reference's (same formulas as librosa.filters.mel).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Periodic Hann window (torch.hann_window / librosa sym=False)."""
    n = torch.arange(win_length, dtype=dtype, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * torch.pi * n / win_length)


def frame_signal(y: torch.Tensor, frame_length: int, hop_length: int) -> torch.Tensor:
    """(B, T) -> (B, n_frames, frame_length), n_frames = 1 + (T - frame_length)//hop."""
    return y.unfold(-1, frame_length, hop_length)


def stft(y: torch.Tensor, n_fft: int, hop_length: int, win_length: Optional[int] = None, *,
         window: Optional[torch.Tensor] = None, center: bool = False) -> torch.Tensor:
    """Complex STFT. (B, T) -> (B, n_frames, n_fft // 2 + 1) complex64: a
    periodic Hann window (zero-padded to n_fft when win_length < n_fft),
    and with center=True a reflect pad of n_fft // 2 on both sides
    (torch.stft's framing)."""
    if win_length is None:
        win_length = n_fft
    if window is None:
        window = hann_window(win_length, y.dtype, y.device)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = F.pad(window, (lpad, n_fft - win_length - lpad))
    if center:
        y = F.pad(y[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    return torch.fft.rfft(frame_signal(y, n_fft, hop_length) * window, n=n_fft, dim=-1)


def _hz_to_mel(f, htk: bool):
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_sp = 200.0 / 3
    mel = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    mel)


def _mel_to_hz(m, htk: bool):
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_sp = 200.0 / 3
    freqs = f_sp * m
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


@lru_cache(maxsize=32)
def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: Optional[float] = None, htk: bool = False,
                   norm: Optional[str] = "slaney") -> np.ndarray:
    """Triangular mel filterbank (n_mels, n_fft//2 + 1), float32 numpy."""
    if fmax is None:
        fmax = sample_rate / 2.0
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    mel_pts = np.linspace(_hz_to_mel(fmin, htk), _hz_to_mel(fmax, htk), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts, htk)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    fb = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        fb *= (2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels]))[:, None]
    return fb.astype(np.float32)


def log_mel_spectrogram(y: torch.Tensor, n_fft: int, n_mels: int,
                        sample_rate: int, hop_length: int, win_length: int,
                        fmin: float = 0.0, fmax: Optional[float] = None,
                        htk: bool = False, clamp: float = 1e-5) -> torch.Tensor:
    """center=True log-mel. (B, T) -> (B, 1 + T // hop_length, n_mels)."""
    mag = stft(y, n_fft, hop_length, win_length, center=True).abs()
    fb = torch.from_numpy(mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax,
                                         htk=htk)).to(y.device)
    return torch.log(torch.clamp(mag @ fb.T, min=clamp))
