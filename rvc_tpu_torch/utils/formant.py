"""Formant shifting (the `stftpitchshift` capability used by
`VoiceConverter` at load time, `rvc/lib/utils.py:63-93`).

STFT-domain formant shift: per frame, extract the spectral envelope via
cepstral liftering, warp it along the frequency axis by `1/quefrency`
factor, and re-apply over the flattened spectrum. `timbre` controls the
warp amount like the reference's formant_timbre. A copy of
`rvc_tpu/utils/formant.py`, host numpy; the port imports nothing of
`rvc_tpu`."""

from __future__ import annotations

import numpy as np


def _stft(a, n_fft, hop):
    win = np.hanning(n_fft)
    pad = n_fft // 2
    x = np.pad(a.astype(np.float64), (pad, pad), mode="reflect")
    n = 1 + (len(x) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n)[:, None]
    return np.fft.rfft(x[idx] * win[None, :], axis=1), win, pad


def _istft(spec, win, n_fft, hop, out_len):
    frames = np.fft.irfft(spec, n=n_fft, axis=1) * win[None, :]
    out = np.zeros(out_len + n_fft)
    norm = np.zeros(out_len + n_fft)
    for i in range(frames.shape[0]):
        s = i * hop
        out[s : s + n_fft] += frames[i]
        norm[s : s + n_fft] += win ** 2
    return out / np.maximum(norm, 1e-8)


def formant_shift(
    audio: np.ndarray,
    sr: int,
    quefrency: float = 1.0,
    timbre: float = 1.0,
    n_fft: int = 1024,
) -> np.ndarray:
    """Shift formants without changing pitch. timbre > 1 raises formants."""
    audio = np.asarray(audio, dtype=np.float32)
    if timbre == 1.0 or len(audio) < n_fft:
        return audio
    hop = n_fft // 4
    spec, win, pad = _stft(audio, n_fft, hop)
    mag = np.abs(spec)
    phase = np.angle(spec)

    # cepstral envelope: lifter the low quefrencies of log|X|
    logmag = np.log(np.maximum(mag, 1e-10))
    ceps = np.fft.irfft(logmag, axis=1)
    lifter_cut = max(8, int(sr / 1000.0 * max(quefrency, 0.25)))
    lift = np.zeros(ceps.shape[1])
    lift[:lifter_cut] = 1.0
    lift[ceps.shape[1] - lifter_cut + 1:] = 1.0
    env = np.real(np.fft.rfft(ceps * lift[None, :], axis=1))  # log envelope

    # warp envelope along frequency by the timbre factor
    bins = np.arange(env.shape[1])
    src_bins = np.clip(bins / timbre, 0, env.shape[1] - 1)
    lo = np.floor(src_bins).astype(int)
    hi = np.minimum(lo + 1, env.shape[1] - 1)
    frac = src_bins - lo
    env_warp = env[:, lo] * (1 - frac) + env[:, hi] * frac

    new_logmag = logmag - env + env_warp
    new_mag = np.exp(new_logmag)
    out = _istft(new_mag * np.exp(1j * phase), win, n_fft, hop, len(audio) + 2 * (n_fft // 2))
    return out[pad : pad + len(audio)].astype(np.float32)
