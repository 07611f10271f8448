"""DSP pitch utilities: YIN ("pm"), autocorrelation baselines, StoneMask
(a copy of `rvc_tpu/pitch/dsp.py`, host numpy; the port imports nothing of
`rvc_tpu`).

  * ``yin_f0``           -- YIN cumulative-mean-normalized difference with
                            parabolic interpolation (the "pm" method)
  * ``stonemask_refine`` -- instantaneous-frequency StoneMask refinement,
                            applied after dio (as ``pw.stonemask``)
  * ``autocorr_f0`` / ``harvest_like_f0`` -- autocorrelation-class
                            estimators, kept as in the reference

All operate on float32 numpy at 16 kHz, hop-aligned with the neural
extractors (hop 160 -> 100 Hz frame rate).
"""

from __future__ import annotations

import numpy as np


def _frame(audio: np.ndarray, frame_length: int, hop: int) -> np.ndarray:
    pad = frame_length // 2
    a = np.pad(audio, (pad, pad), mode="reflect")
    n = 1 + (len(a) - frame_length) // hop
    idx = np.arange(frame_length)[None, :] + hop * np.arange(n)[:, None]
    return a[idx]


def yin_f0(
    audio: np.ndarray,
    sample_rate: int = 16000,
    hop: int = 160,
    f0_min: float = 50.0,
    f0_max: float = 1100.0,
    threshold: float = 0.35,
    frame_length: int = 1024,
) -> np.ndarray:
    """YIN: cumulative mean normalized difference function, absolute
    threshold, parabolic interpolation. Returns per-frame f0 (0=unvoiced).

    Default CMND threshold 0.35, the reference's (its
    `scripts/tune_dsp_pitch.py` sweep)."""
    audio = np.asarray(audio, dtype=np.float64)
    frames = _frame(audio, frame_length, hop)  # (T, W)
    tau_max = min(int(sample_rate / f0_min) + 2, frame_length - 2)
    tau_min = max(int(sample_rate / f0_max), 2)

    # difference function via FFT autocorrelation:
    # d(tau) = E1(tau) + E2(tau) - 2*acf(tau) with
    #   E1(tau) = sum_{j<W-tau} x[j]^2,  E2(tau) = sum_{j>=tau} x[j]^2
    W = frame_length
    nfft = 2 * W
    fft = np.fft.rfft(frames, nfft, axis=1)
    acf = np.fft.irfft(fft * np.conj(fft), nfft, axis=1)[:, :tau_max + 1]
    energy = np.cumsum(frames ** 2, axis=1)
    r0 = energy[:, -1][:, None]
    taus = np.arange(tau_max + 1)
    e1 = energy[:, W - 1 - taus]
    e2 = r0 - np.concatenate(
        [np.zeros((frames.shape[0], 1)), energy[:, :tau_max]], axis=1)
    d = e1 + e2 - 2.0 * acf  # (T, tau_max+1)
    d = np.maximum(d, 0.0)

    # cumulative mean normalized difference
    tau = np.arange(1, tau_max + 1)
    csum = np.cumsum(d[:, 1:], axis=1)
    cmnd = np.ones((frames.shape[0], tau_max + 1))
    cmnd[:, 1:] = d[:, 1:] * tau[None, :] / np.maximum(csum, 1e-12)

    # YIN selection: first tau whose cmnd dips under the threshold, then
    # walk to the local minimum of that below-threshold run
    region = cmnd[:, tau_min:tau_max]
    n = region.shape[1]
    under = region < threshold
    first = np.argmax(under, axis=1)
    has_under = under.any(axis=1)
    cols = np.arange(n)[None, :]
    after = cols >= first[:, None]
    exit_mask = (~under) & after
    run_end = np.where(exit_mask.any(axis=1), np.argmax(exit_mask, axis=1), n)
    in_run = after & (cols < run_end[:, None])
    best_in_run = np.argmin(np.where(in_run, region, np.inf), axis=1)
    best = np.where(has_under, best_in_run, np.argmin(region, axis=1)) + tau_min

    # parabolic interpolation around best tau
    t = np.arange(frames.shape[0])
    b0 = cmnd[t, np.maximum(best - 1, 1)]
    b1 = cmnd[t, best]
    b2 = cmnd[t, np.minimum(best + 1, tau_max)]
    denom = b0 + b2 - 2 * b1
    shift = np.where(np.abs(denom) > 1e-12, 0.5 * (b0 - b2) / np.maximum(np.abs(denom), 1e-12) * np.sign(denom), 0.0)
    shift = np.clip(shift, -0.5, 0.5)
    period = best + shift

    f0 = sample_rate / np.maximum(period, 1e-6)
    voiced = has_under & (f0 >= f0_min) & (f0 <= f0_max)
    # also gate on frame energy
    rms = np.sqrt(np.mean(frames ** 2, axis=1))
    voiced &= rms > (0.01 * max(np.sqrt(np.mean(audio ** 2)), 1e-8))
    return np.where(voiced, f0, 0.0).astype(np.float32)


def autocorr_f0(
    audio: np.ndarray,
    sample_rate: int = 16000,
    hop: int = 160,
    f0_min: float = 50.0,
    f0_max: float = 1100.0,
    frame_length: int = 1024,
    clarity_threshold: float = 0.45,
    median: int = 3,
) -> np.ndarray:
    """Normalized autocorrelation peak-picking ("dio"-class)."""
    audio = np.asarray(audio, dtype=np.float64)
    frames = _frame(audio, frame_length, hop)
    frames = frames - frames.mean(axis=1, keepdims=True)
    win = np.hanning(frame_length)
    fw = frames * win[None, :]
    nfft = 2 * frame_length
    fft = np.fft.rfft(fw, nfft, axis=1)
    acf = np.fft.irfft(fft * np.conj(fft), nfft, axis=1)
    tau_max = min(int(sample_rate / f0_min) + 2, frame_length - 2)
    tau_min = max(int(sample_rate / f0_max), 2)
    norm = np.maximum(acf[:, :1], 1e-12)
    r = acf[:, : tau_max + 1] / norm

    region = r[:, tau_min:tau_max]
    best = np.argmax(region, axis=1) + tau_min
    t = np.arange(frames.shape[0])
    clarity = r[t, best]

    # parabolic interpolation
    b0 = r[t, best - 1]
    b1 = r[t, best]
    b2 = r[t, best + 1]
    denom = b0 + b2 - 2 * b1
    shift = np.where(np.abs(denom) > 1e-12, 0.5 * (b0 - b2) / np.where(np.abs(denom) > 1e-12, denom, 1.0), 0.0)
    period = best - np.clip(shift, -0.5, 0.5)

    f0 = sample_rate / np.maximum(period, 1e-6)
    voiced = (clarity > clarity_threshold) & (f0 >= f0_min) & (f0 <= f0_max)
    f0 = np.where(voiced, f0, 0.0)
    if median > 1:
        from scipy.ndimage import median_filter
        f0 = np.where(f0 > 0, median_filter(f0, size=median), 0.0)
    return f0.astype(np.float32)


def harvest_like_f0(
    audio: np.ndarray,
    sample_rate: int = 16000,
    hop: int = 160,
    f0_min: float = 50.0,
    f0_max: float = 1100.0,
) -> np.ndarray:
    """"harvest"-class: longer analysis window, stronger smoothing, octave
    error correction by path continuity."""
    f0 = autocorr_f0(audio, sample_rate, hop, f0_min, f0_max,
                     frame_length=2048, clarity_threshold=0.35, median=5)
    # fix isolated octave jumps against the local median
    v = f0 > 0
    if v.sum() > 4:
        from scipy.ndimage import median_filter
        med = median_filter(np.where(v, f0, np.nan), size=9, mode="nearest")
        med = np.where(np.isnan(med), f0, med)
        for mult in (2.0, 0.5):
            jump = v & (med > 0) & (np.abs(f0 * mult - med) < 0.12 * med)
            f0 = np.where(jump, f0 * mult, f0)
    return f0.astype(np.float32)


def stonemask_refine(
    audio: np.ndarray,
    f0: np.ndarray,
    sample_rate: int = 16000,
    hop: int = 160,
    iterations: int = 2,
) -> np.ndarray:
    """StoneMask refinement: re-estimate each voiced frame's f0 as the
    amplitude-weighted mean of the INSTANTANEOUS FREQUENCY (one-sample
    phase-difference spectrum) at its first harmonics — WORLD's actual
    StoneMask mechanism (Morise 2016; reference contract
    `rvc_mlx/lib/mlx/pyworld_pitch.py:125` pw.dio + pw.stonemask).
    Two iterations converge."""
    from rvc_tpu_torch.pitch.world_dsp import (
        _instantaneous_frequency_map,
        _refine_by_harmonics,
        _remove_dc,
    )

    f0 = np.asarray(f0, dtype=np.float64)
    if not (f0 > 0).any():
        return f0.astype(np.float32)
    x = _remove_dc(audio, sample_rate, max(float(f0[f0 > 0].min()), 25.0))
    n = len(f0)
    inst, mag, bin_hz = _instantaneous_frequency_map(x, sample_rate, hop, n)
    out = f0.copy()
    for _ in range(iterations):
        refined, _, _ = _refine_by_harmonics(out, inst, mag, bin_hz,
                                             sample_rate)
        # keep the refinement only where it stays near the coarse value
        # (a StoneMask invariant: it sharpens, never re-voices)
        ok = (out > 0) & (refined > 0) & (
            np.abs(refined - out) < 0.2 * np.maximum(out, 1.0))
        out = np.where(ok, refined, out)
    return out.astype(np.float32)
