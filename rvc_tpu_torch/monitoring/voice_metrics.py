"""Voice-quality metrics (a host numpy copy of
`rvc_tpu/monitoring/voice_metrics.py`): F0 accuracy (voiced agreement +
cent error), mel-cepstral distortion, spectrogram correlation, the
reference's log-mel parity correlation, and SNR. The mel filterbank is the
port's own (`ops.stft.mel_filterbank`).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from rvc_tpu_torch.ops.stft import mel_filterbank


def f0_accuracy(f0_ref: np.ndarray, f0_est: np.ndarray,
                cent_tolerance: float = 50.0) -> Dict[str, float]:
    """Voiced/unvoiced agreement + fraction of voiced frames within
    `cent_tolerance` cents + mean absolute cent error."""
    n = min(len(f0_ref), len(f0_est))
    r, e = np.asarray(f0_ref[:n]), np.asarray(f0_est[:n])
    vr, ve = r > 0, e > 0
    vuv_agree = float(np.mean(vr == ve)) if n else 0.0
    both = vr & ve
    if both.sum() == 0:
        return dict(vuv_accuracy=vuv_agree, pitch_accuracy=0.0,
                    mean_cent_error=float("inf"))
    cents = 1200.0 * np.abs(np.log2(e[both] / r[both]))
    return dict(
        vuv_accuracy=vuv_agree,
        pitch_accuracy=float(np.mean(cents <= cent_tolerance)),
        mean_cent_error=float(np.mean(cents)),
    )


def _mfcc_like(audio: np.ndarray, sr: int, n_mfcc: int = 13,
               n_fft: int = 1024, hop: int = 256) -> np.ndarray:
    pad = n_fft // 2
    a = np.pad(np.asarray(audio, dtype=np.float64), (pad, pad), mode="reflect")
    n = 1 + (len(a) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n)[:, None]
    frames = a[idx] * np.hanning(n_fft)
    mag = np.abs(np.fft.rfft(frames, axis=1))
    fb = mel_filterbank(sr, n_fft, 40, 0, None, htk=True)
    logmel = np.log(np.maximum(mag @ fb.T, 1e-10))
    # DCT-II, orthonormal
    k = np.arange(40)
    dct = np.cos(np.pi / 40 * (k[None, :] + 0.5) * np.arange(n_mfcc)[:, None])
    return logmel @ dct.T  # (T, n_mfcc)


def mel_cepstral_distortion(ref: np.ndarray, est: np.ndarray, sr: int) -> float:
    """MCD in dB over aligned frames (c1..c12)."""
    m1 = _mfcc_like(ref, sr)
    m2 = _mfcc_like(est, sr)
    n = min(len(m1), len(m2))
    if n == 0:
        return float("inf")
    d = m1[:n, 1:] - m2[:n, 1:]
    return float((10.0 / np.log(10)) * np.sqrt(2.0) *
                 np.mean(np.sqrt(np.sum(d * d, axis=1))))


def spectrogram_correlation(ref: np.ndarray, est: np.ndarray,
                            n_fft: int = 2048, hop: int = 512,
                            top_db: Optional[float] = None) -> float:
    """Pearson correlation of log-magnitude spectrograms — the reference's
    perceptual-parity bar is > 0.95 (`benchmark_audio_parity.py:438`).

    top_db: optional dynamic-range cap (librosa-style): magnitudes are
    floored at ref's peak magnitude * 10^(-top_db/20) in BOTH signals
    before the log. Without it, bins ~180 dB below peak dominate the
    correlation with float noise — two waveforms with 0.999 sample
    correlation can score 0.5 purely from sub-audible-bin log spread.
    Use top_db=80 when comparing reduced-precision paths; leave None
    for the reference-semantics metric."""
    def mag(a):
        a = np.asarray(a, dtype=np.float64)
        n = 1 + max(0, (len(a) - n_fft)) // hop
        idx = np.arange(n_fft)[None, :] + hop * np.arange(n)[:, None]
        frames = a[idx] * np.hanning(n_fft)
        return np.abs(np.fft.rfft(frames, axis=1))

    n = min(len(ref), len(est))
    m1, m2 = mag(ref[:n]), mag(est[:n])
    floor = 1e-8
    if top_db is not None:
        floor = max(float(m1.max()) * 10.0 ** (-top_db / 20.0), 1e-8)
    s1 = np.log(np.maximum(m1, floor)).ravel()
    s2 = np.log(np.maximum(m2, floor)).ravel()
    if s1.std() < 1e-9 or s2.std() < 1e-9:
        return 0.0
    return float(np.corrcoef(s1, s2)[0, 1])


def log_mel_correlation(ref: np.ndarray, est: np.ndarray, sr: int,
                        n_fft: int = 1024, hop: int = 256,
                        n_mels: int = 80, top_db: float = 80.0) -> float:
    """The reference's EXACT perceptual-parity metric
    (`benchmark_audio_parity.py:396-419`, pass bar > 0.95 at `:438`):
    center-padded |STFT(n_fft=1024, hop=256)|, mel power spectrogram
    (n_mels=80, slaney scale + norm — librosa defaults), then
    librosa.power_to_db(ref=np.max) whose default top_db=80 caps each
    signal 80 dB below its own peak; Pearson correlation of the
    flattened dB arrays.

    This is a mel-pooled log-POWER metric with per-signal peak
    normalization — materially more perceptual (and more forgiving of
    broadband sub-audible error) than `spectrogram_correlation`'s
    1025-bin linear-frequency log-magnitude, which this repo keeps as
    the stricter engineering metric."""
    def logmel_db(a):
        a = np.asarray(a, dtype=np.float64)
        pad = n_fft // 2
        a = np.pad(a, (pad, pad), mode="reflect")
        n = 1 + (len(a) - n_fft) // hop
        idx = np.arange(n_fft)[None, :] + hop * np.arange(n)[:, None]
        # librosa hann is periodic (sym=False)
        win = np.hanning(n_fft + 1)[:-1]
        power = np.abs(np.fft.rfft(a[idx] * win, axis=1)) ** 2
        fb = mel_filterbank(sr, n_fft, n_mels, htk=False, norm="slaney")
        mel = power @ fb.T.astype(np.float64)
        ref_p = max(mel.max(), 1e-10)
        db = 10.0 * np.log10(np.maximum(mel, 1e-10) / ref_p)
        return np.maximum(db, -top_db)

    n = min(len(ref), len(est))
    s1 = logmel_db(ref[:n]).ravel()
    s2 = logmel_db(est[:n]).ravel()
    if s1.std() < 1e-9 or s2.std() < 1e-9:
        return 0.0
    return float(np.corrcoef(s1, s2)[0, 1])


def signal_to_noise_ratio(ref: np.ndarray, est: np.ndarray) -> float:
    n = min(len(ref), len(est))
    ref, est = np.asarray(ref[:n], np.float64), np.asarray(est[:n], np.float64)
    noise = ref - est
    p_sig = np.sum(ref ** 2)
    p_noise = max(np.sum(noise ** 2), 1e-12)
    return float(10.0 * np.log10(max(p_sig, 1e-12) / p_noise))
