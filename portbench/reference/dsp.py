"""Signal processing of the plain reference: the high-pass, the log-mel of
RMVPE, the training spectrograms and the pitch decode (frozen copies of the
formulas the RVC reference uses; numpy, scipy and plain torch)."""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional

import numpy as np
import torch
from scipy import signal
from torch.nn import functional as F

F0_MIN, F0_MAX = 50.0, 1100.0
F0_MEL_MIN = 1127.0 * math.log(1.0 + F0_MIN / 700.0)
F0_MEL_MAX = 1127.0 * math.log(1.0 + F0_MAX / 700.0)
CENTS = (20.0 * np.arange(360) + 1997.3794084376191).astype(np.float32)


def highpass(audio: np.ndarray, sr: int = 16000, cutoff: float = 48.0,
             order: int = 5) -> np.ndarray:
    """Butterworth high-pass, zero phase (filtfilt)."""
    b, a = signal.butter(order, cutoff, btype="high", fs=sr)
    return signal.filtfilt(b, a, audio).astype(np.float32)


def peak_normalize(audio: np.ndarray, peak: float = 0.99) -> np.ndarray:
    m = np.abs(audio).max() / peak
    return (audio / m).astype(np.float32) if m > 1 else audio.astype(np.float32)


def _hz_to_mel(f, htk):
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_hz / f_sp + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz(m, htk):
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_hz / f_sp,
                    min_log_hz * np.exp(logstep * (m - min_log_hz / f_sp)), f_sp * m)


@lru_cache(maxsize=16)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: Optional[float] = None, htk: bool = False) -> np.ndarray:
    """Triangular mel filters (n_mels, n_fft // 2 + 1) with Slaney area
    normalisation (librosa.filters.mel's formulas)."""
    fmax = sr / 2.0 if fmax is None else fmax
    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(fmin, htk), _hz_to_mel(fmax, htk), n_mels + 2), htk)
    ramps = hz[:, None] - freqs[None, :]
    fdiff = np.diff(hz)
    fb = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    fb *= (2.0 / (hz[2: n_mels + 2] - hz[:n_mels]))[:, None]
    return fb.astype(np.float32)


def _window(n: int, device) -> torch.Tensor:
    k = torch.arange(n, dtype=torch.float32, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * k / n)


def _stft_mag(y: torch.Tensor, n_fft: int, hop: int, win: int, center: bool) -> torch.Tensor:
    """|STFT| (B, frames, n_fft // 2 + 1), periodic Hann."""
    w = _window(win, y.device)
    if win < n_fft:
        lp = (n_fft - win) // 2
        w = F.pad(w, (lp, n_fft - win - lp))
    if center:
        y = F.pad(y[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    return torch.fft.rfft(y.unfold(-1, n_fft, hop) * w, n=n_fft, dim=-1).abs()


def rmvpe_log_mel(audio: torch.Tensor) -> torch.Tensor:
    """RMVPE's front end: (B, T) 16 kHz -> (B, 1 + T // 160, 128), HTK mels
    over 30-8000 Hz, center framing, log(clamp 1e-5)."""
    mag = _stft_mag(audio, 1024, 160, 1024, True)
    fb = torch.from_numpy(mel_filterbank(16000, 1024, 128, 30.0, 8000.0, True)).to(audio.device)
    return torch.log(torch.clamp(mag @ fb.T, min=1e-5))


def spectrogram(y: torch.Tensor, n_fft: int, hop: int, win: int) -> torch.Tensor:
    """Training's linear magnitude (B, frames, bins): reflect pad (n_fft -
    hop) / 2, no centre, sqrt(re^2 + im^2 + 1e-6)."""
    pad = int((n_fft - hop) / 2)
    y = F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
    w = _window(win, y.device)
    if win < n_fft:
        lp = (n_fft - win) // 2
        w = F.pad(w, (lp, n_fft - win - lp))
    z = torch.fft.rfft(y.unfold(-1, n_fft, hop) * w, n=n_fft, dim=-1)
    return torch.sqrt(z.real ** 2 + z.imag ** 2 + 1e-6)


def mel_spectrogram(y, n_fft, n_mels, sr, hop, win, fmin=0.0, fmax=None):
    spec = spectrogram(y, n_fft, hop, win)
    fb = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels, fmin, fmax)).to(y.device)
    return torch.log(torch.clamp(spec @ fb.T, min=1e-5))


def decode_salience(hidden: torch.Tensor, thred: float = 0.03) -> torch.Tensor:
    """(B, T, 360) salience -> f0 in Hz (0 unvoiced): the salience-weighted
    mean of the cents of the 9 bins around the peak, where the peak passes
    the threshold."""
    center = torch.argmax(hidden, dim=-1)
    idx = center[..., None] + torch.arange(9, device=hidden.device)
    w = torch.gather(F.pad(hidden, (4, 4)), -1, idx)
    cents_pad = F.pad(torch.from_numpy(CENTS), (4, 4)).to(hidden.device)
    wsum = w.sum(-1)
    cents = torch.where(wsum > 0, (w * cents_pad[idx]).sum(-1) / wsum.clamp_min(1e-12),
                        torch.zeros_like(wsum))
    cents = torch.where(hidden.amax(-1) > thred, cents, torch.zeros_like(cents))
    f0 = 10.0 * 2.0 ** (cents / 1200.0)
    return torch.where(cents > 0, f0, torch.zeros_like(f0))


def coarse_f0(f0: torch.Tensor) -> torch.Tensor:
    """f0 (Hz) -> the 1..255 mel-spaced bins of the pitch embedding."""
    mel = 1127.0 * torch.log(1.0 + f0 / 700.0)
    scaled = torch.where(mel > 0, (mel - F0_MEL_MIN) * 254.0 / (F0_MEL_MAX - F0_MEL_MIN) + 1.0,
                         mel)
    return torch.round(torch.clamp(scaled, 1.0, 255.0)).long()
