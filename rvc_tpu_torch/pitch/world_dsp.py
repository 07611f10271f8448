"""DIO and Harvest pitch extractors, WORLD's algorithms in host numpy
(a copy of `rvc_tpu/pitch/world_dsp.py`; the port imports nothing of
`rvc_tpu`). The reference's upstream delegates both to the pyworld C++
library; these are reimplementations of the published algorithms
(Morise 2009/2016):

DIO (``dio_f0``):
  1. channel bank of Nuttall-FIR low-pass filters, boundary
     frequencies ``f0_floor * 2^((i+1)/channels_in_octave)``;
  2. per channel, FOUR event-interval f0 estimates from the filtered
     waveform (negative/positive zero crossings, peak and dip
     intervals), each interpolated onto the frame grid;
  3. per frame, the channel whose four estimates agree best (smallest
     relative deviation) wins; large deviation = unvoiced;
  4. contour fixing: jump removal and short-segment pruning.
  The facade applies StoneMask refinement afterwards, as
  ``pw.dio`` + ``pw.stonemask``.

Harvest (``harvest_f0``):
  1. DENSE band-pass channel bank (cos-modulated Nuttall FIR, the
     filter family WORLD uses), 40 channels an octave;
  2. the same four-interval estimator gives one candidate contour per
     channel, kept only near its channel's center frequency;
  3. every candidate is refined by harmonic-weighted INSTANTANEOUS
     FREQUENCY (phase-derivative spectrum, first 6 harmonics) and
     scored by harmonic agreement;
  4. best-scoring candidate per frame, contour fixing, and low-pass
     smoothing of voiced segments.

Voicing decisions on ambiguous frames are not bit-identical to pyworld's.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import fftconvolve


# ---------------------------------------------------------------- filters
def _nuttall(n: int) -> np.ndarray:
    """4-term Nuttall window, WORLD's FIR prototype."""
    t = np.arange(n) * (2.0 * np.pi / max(n - 1, 1))
    return (0.355768 - 0.487396 * np.cos(t) + 0.144232 * np.cos(2 * t)
            - 0.012604 * np.cos(3 * t))


def _lowpass_nuttall(x: np.ndarray, sr: int, cutoff: float) -> np.ndarray:
    """DIO's channel filter: a Nuttall window used as a low-pass FIR
    with length ~ 2 periods of the boundary frequency."""
    half = max(int(round(sr / cutoff / 2.0)), 2)
    fir = _nuttall(half * 4 + 1)
    fir /= fir.sum()
    return fftconvolve(x, fir, mode="same")


def _bandpass_nuttall(x: np.ndarray, sr: int, center: float) -> np.ndarray:
    """Harvest's channel filter: cos-modulated Nuttall FIR centered on
    the channel frequency (length ~ 4 periods)."""
    half = max(int(round(sr / center * 2.0)), 2)
    n = np.arange(-half, half + 1)
    fir = _nuttall(2 * half + 1) * np.cos(2.0 * np.pi * center * n / sr)
    return fftconvolve(x, fir, mode="same")


def _remove_dc(x: np.ndarray, sr: int, f0_floor: float) -> np.ndarray:
    """Low-cut below the pitch floor (WORLD applies a low-cut filter
    before candidate generation)."""
    from scipy.signal import butter, sosfiltfilt

    x = np.asarray(x, dtype=np.float64)
    x = x - x.mean()
    cut = max(0.7 * f0_floor, 25.0)
    sos = butter(2, cut / (sr / 2), btype="high", output="sos")
    return sosfiltfilt(sos, x)


# ------------------------------------------------- four-interval estimator
def _event_times(y: np.ndarray, sr: int, rising: bool) -> np.ndarray:
    """Sub-sample times of rising (neg->pos) or falling zero crossings."""
    neg = y < 0
    if rising:
        idx = np.where(neg[:-1] & ~neg[1:])[0]
    else:
        idx = np.where(~neg[:-1] & neg[1:])[0]
    if len(idx) < 3:
        return np.empty(0)
    denom = y[idx] - y[idx + 1]
    frac = np.where(np.abs(denom) > 1e-12, y[idx] / np.where(
        np.abs(denom) > 1e-12, denom, 1.0), 0.5)
    return (idx + frac) / sr


def _interval_contour(times: np.ndarray, frame_times: np.ndarray) -> np.ndarray:
    """Interval-based f0 series interpolated onto the frame grid
    (0 outside the observed event span)."""
    if len(times) < 3:
        return np.zeros(len(frame_times))
    f0 = 1.0 / np.diff(times)
    mid = 0.5 * (times[1:] + times[:-1])
    out = np.interp(frame_times, mid, f0)
    out[(frame_times < mid[0]) | (frame_times > mid[-1])] = 0.0
    return out


def _four_interval_estimates(y: np.ndarray, sr: int,
                             frame_times: np.ndarray) -> np.ndarray:
    """(4, T) f0 estimates: rising/falling zero crossings of the
    waveform, and of its derivative (= peaks and dips)."""
    dy = np.diff(y)
    return np.stack([
        _interval_contour(_event_times(y, sr, True), frame_times),
        _interval_contour(_event_times(y, sr, False), frame_times),
        _interval_contour(_event_times(dy, sr, True), frame_times),
        _interval_contour(_event_times(dy, sr, False), frame_times),
    ])


def _boundaries(f0_floor: float, f0_ceil: float,
                channels_in_octave: float) -> np.ndarray:
    n = int(np.ceil(np.log2(f0_ceil / f0_floor) * channels_in_octave))
    return f0_floor * 2.0 ** ((np.arange(n) + 1.0) / channels_in_octave)


# ------------------------------------------------------- contour fixing
def _fix_contour(f0: np.ndarray, allowed_range: float = 0.1,
                 min_frames: int = 6, max_gap: int = 2) -> np.ndarray:
    """DIO/Harvest FixF0Contour essence: (1) zero frame-to-frame jumps
    beyond allowed_range (forward and backward passes, so a jump's far
    side survives); (2) bridge short unvoiced gaps inside voiced runs;
    (3) drop voiced islands shorter than min_frames."""
    f0 = f0.astype(np.float64).copy()
    for sl in (slice(None, None, 1), slice(None, None, -1)):
        g = f0[sl]
        bad = np.zeros(len(g), dtype=bool)
        prev = 0.0
        for i in range(len(g)):
            if g[i] <= 0:
                prev = 0.0
                continue
            if prev > 0 and abs(g[i] - prev) / prev > allowed_range:
                bad[i] = True
                prev = 0.0
            else:
                prev = g[i]
        g[bad] = 0.0
        f0[sl] = g

    # bridge short gaps by linear interpolation between voiced neighbors
    v = f0 > 0
    if v.any():
        idx = np.where(v)[0]
        gaps = np.diff(idx)
        for j, g in enumerate(gaps):
            if 1 < g <= max_gap + 1:
                a, b = idx[j], idx[j + 1]
                f0[a + 1 : b] = np.interp(np.arange(a + 1, b), [a, b],
                                          [f0[a], f0[b]])
    # prune short voiced islands
    v = f0 > 0
    edges = np.flatnonzero(np.diff(np.concatenate([[0], v.view(np.int8), [0]])))
    for s, e in zip(edges[::2], edges[1::2]):
        if e - s < min_frames:
            f0[s:e] = 0.0
    return f0


# ----------------------------------------------------------------- DIO
def dio_f0(
    audio: np.ndarray,
    sample_rate: int = 16000,
    hop: int = 160,
    f0_min: float = 50.0,
    f0_max: float = 1100.0,
    channels_in_octave: float = 2.0,
    deviation_threshold: float = 0.02,
) -> np.ndarray:
    """DIO: per-channel low-pass -> four-interval agreement -> best
    channel per frame -> contour fixing. Returns (T,) f0, 0=unvoiced.
    Pair with ``dsp.stonemask_refine`` for the reference's
    ``pw.dio + pw.stonemask`` contract."""
    x = _remove_dc(audio, sample_rate, f0_min)
    n_frames = len(x) // hop + 1
    frame_times = np.arange(n_frames) * (hop / sample_rate)

    best_f0 = np.zeros(n_frames)
    best_score = np.full(n_frames, np.inf)
    for b in _boundaries(f0_min, f0_max, channels_in_octave):
        yf = _lowpass_nuttall(x, sample_rate, b)
        ests = _four_interval_estimates(yf, sample_rate, frame_times)
        mean = ests.mean(axis=0)
        with np.errstate(invalid="ignore", divide="ignore"):
            dev = np.sqrt(((ests - mean) ** 2).mean(axis=0)) / np.maximum(
                mean, 1e-9)
        # a channel's candidate is usable only if every one of the four
        # estimators saw the same periodicity inside the channel's band
        valid = ((ests > b / 2.0) & (ests < b * 2.0)).all(axis=0)
        valid &= (mean >= f0_min) & (mean <= f0_max)
        score = np.where(valid, dev, np.inf)
        better = score < best_score
        best_f0 = np.where(better, mean, best_f0)
        best_score = np.minimum(best_score, score)

    f0 = np.where(best_score < deviation_threshold, best_f0, 0.0)
    return _fix_contour(f0).astype(np.float32)


# ------------------------------------------------------------- Harvest
def _instantaneous_frequency_map(x: np.ndarray, sr: int, hop: int,
                                 n_frames: int, frame_length: int = 1024):
    """Per-frame instantaneous-frequency spectrum via the one-sample
    phase-difference method: IF(bin) = sr/2pi * arg(X_{t+1} conj(X_t)),
    plus the magnitude spectrum for harmonic weighting."""
    pad = frame_length // 2
    a = np.pad(x, (pad, pad + hop + 1), mode="constant")
    idx = (np.arange(frame_length)[None, :]
           + hop * np.arange(n_frames)[:, None])
    win = np.hanning(frame_length)
    f1 = a[idx] * win[None, :]
    f2 = a[idx + 1] * win[None, :]
    X1 = np.fft.rfft(f1, axis=1)
    X2 = np.fft.rfft(f2, axis=1)
    inst = np.angle(X2 * np.conj(X1)) * (sr / (2.0 * np.pi))
    return inst, np.abs(X1), sr / frame_length


def _refine_by_harmonics(f0_cand: np.ndarray, inst: np.ndarray,
                         mag: np.ndarray, bin_hz: float, sr: int,
                         n_harmonics: int = 6):
    """Refine a (T,) candidate contour by amplitude-weighted mean of
    instantaneous frequencies at its first harmonics.

    Two quantities come back per frame: the refined f0, and a score
    combining (a) IF agreement across harmonics, (b) HARMONIC
    CONTRAST — mean magnitude at the harmonic bins over mean magnitude
    across the band [f0/2, (n+0.5) f0] — and (c) a MIDPOINT penalty:
    magnitude at the inter-harmonic bins (h - 1/2) f0. (a) alone cannot
    reject noise (a noisy bin's IF sits near its own center frequency,
    so IF(h f)/h ~ f automatically); (b) makes the voicing decision;
    (c) kills octave-up errors — when the candidate is 2x the true f0,
    its "midpoints" land on REAL harmonics and carry as much energy as
    its "harmonics", where a true-f0 candidate's midpoints are spectral
    valleys. Spectral tilt otherwise biases (b) toward high harmonics."""
    T, n_bins = inst.shape
    t = np.arange(T)
    est = np.zeros((n_harmonics, T))
    w = np.zeros((n_harmonics, T))
    for h in range(1, n_harmonics + 1):
        bins = np.clip(np.round(f0_cand * h / bin_hz).astype(int), 1,
                       n_bins - 2)
        ifreq = inst[t, bins] / h
        est[h - 1] = ifreq
        w[h - 1] = mag[t, bins]
        # harmonics above Nyquist contribute nothing
        w[h - 1][f0_cand * h > sr / 2 - bin_hz] = 0.0
    wsum = np.maximum(w.sum(axis=0), 1e-12)
    refined = (est * w).sum(axis=0) / wsum
    with np.errstate(invalid="ignore", divide="ignore"):
        spread = np.sqrt((w * (est - refined) ** 2).sum(axis=0) / wsum)
        agree = 1.0 / (1.0 + spread / np.maximum(refined, 1e-9) * 20.0)
    # harmonic contrast: band-mean magnitude via cumulative sums
    csum = np.cumsum(mag, axis=1)
    n_used = np.maximum((w > 0).sum(axis=0), 1)
    lo = np.clip((f0_cand / 2.0 / bin_hz).astype(int), 0, n_bins - 2)
    hi = np.clip(((n_used + 0.5) * f0_cand / bin_hz).astype(int) + 1, 1,
                 n_bins - 1)
    band_mean = (csum[t, hi] - csum[t, lo]) / np.maximum(hi - lo, 1)
    harm_mean = wsum / n_used
    contrast = harm_mean / np.maximum(band_mean, 1e-12)
    # midpoint (inter-harmonic) magnitude at (h - 1/2) f0
    mid = np.zeros((n_harmonics, T))
    for h in range(1, n_harmonics + 1):
        bins = np.clip(np.round(f0_cand * (h - 0.5) / bin_hz).astype(int),
                       1, n_bins - 2)
        mid[h - 1] = np.where(w[h - 1] > 0, mag[t, bins], 0.0)
    mid_mean = mid.sum(axis=0) / n_used
    valley = np.clip(1.0 - mid_mean / np.maximum(harm_mean, 1e-12), 0.0, 1.0)
    score = agree * np.clip((contrast - 1.0) / 1.5, 0.0, 1.0) * valley
    score = np.where((f0_cand > 0) & (refined > 0), score, 0.0)
    # magnitude at the candidate's own fundamental bin: the octave-class
    # preference in harvest_f0 must not elect a subharmonic that has no
    # energy at its claimed f0 (a pure tone at f has a scoreable f/2
    # candidate whose "harmonics" are {f/2: none, f: real})
    fund = w[0]
    return np.where(refined > 0, refined, 0.0), score, fund


def _smooth_voiced(f0: np.ndarray, kernel: int = 5) -> np.ndarray:
    """Harvest's final SmoothF0Contour analog: short moving-average of
    each voiced segment (edges handled per segment)."""
    out = f0.copy()
    v = f0 > 0
    edges = np.flatnonzero(np.diff(np.concatenate([[0], v.view(np.int8), [0]])))
    k = np.ones(kernel) / kernel
    for s, e in zip(edges[::2], edges[1::2]):
        if e - s >= kernel:
            seg = np.pad(f0[s:e], (kernel // 2, kernel // 2), mode="edge")
            out[s:e] = np.convolve(seg, k, mode="valid")
    return out


def _octave_repair(f0: np.ndarray, size: int = 15) -> np.ndarray:
    """Move frames whose halved/doubled value sits clearly closer to the
    local voiced median (isolated harmonic/subharmonic locks)."""
    from scipy.ndimage import median_filter

    v = f0 > 0
    if v.sum() < 5:
        return f0
    med = median_filter(np.where(v, f0, np.nan), size=size, mode="nearest")
    med = np.where(np.isnan(med), f0, med)
    out = f0.copy()
    with np.errstate(divide="ignore", invalid="ignore"):
        for mult in (0.5, 2.0):
            cur = np.abs(np.log2(np.maximum(out, 1e-9)
                                 / np.maximum(med, 1e-9)))
            alt = np.abs(np.log2(np.maximum(out, 1e-9) * mult
                                 / np.maximum(med, 1e-9)))
            out = np.where(v & (med > 0) & (alt < cur - 0.3), out * mult, out)
    return out


def harvest_f0(
    audio: np.ndarray,
    sample_rate: int = 16000,
    hop: int = 160,
    f0_min: float = 50.0,
    f0_max: float = 1100.0,
    channels_in_octave: float = 40.0,
    score_threshold: float = 0.25,
    margin: float = 0.25,
) -> np.ndarray:
    """Harvest: dense band-passed candidate generation, instantaneous-
    frequency harmonic refinement, candidate selection with SUBHARMONIC
    PREFERENCE, contour fixing + smoothing. Returns (T,) f0, 0=unvoiced
    (no stonemask, the reference's ``pw.harvest`` contract).

    Selection: among a frame's candidates scoring within ``margin`` of
    its best, the lowest octave class wins (the highest-scoring
    candidate within 100 cents of the lowest survivor). Spectral tilt
    makes raw spectral scores favor 2x/4x harmonics on natural voices;
    preferring the lowest well-supported candidate plus a local-median
    octave repair is what keeps the contour on the fundamental
    (measured on the real 13.5 s clip vs the RMVPE golden contour:
    argmax selection = 2129 c median error, this selection = 12 c)."""
    x = _remove_dc(audio, sample_rate, f0_min)
    n_frames = len(x) // hop + 1
    frame_times = np.arange(n_frames) * (hop / sample_rate)
    inst, mag, bin_hz = _instantaneous_frequency_map(x, sample_rate, hop,
                                                     n_frames)

    cand_f0, cand_score, cand_fund = [], [], []
    for b in _boundaries(f0_min, f0_max, channels_in_octave):
        yf = _bandpass_nuttall(x, sample_rate, b)
        ests = _four_interval_estimates(yf, sample_rate, frame_times)
        mean = ests.mean(axis=0)
        # keep the candidate only where the filtered signal's apparent
        # period sits inside the channel (a band-passed signal whose
        # zero crossings disagree with the band carries no pitch there)
        ratio = 2.0 ** (1.0 / channels_in_octave)
        valid = ((ests > b / (ratio * 1.5)) & (ests < b * ratio * 1.5)
                 ).all(axis=0)
        valid &= (mean >= f0_min) & (mean <= f0_max)
        cand = np.where(valid, mean, 0.0)
        if not valid.any():
            continue
        refined, score, fund = _refine_by_harmonics(cand, inst, mag,
                                                    bin_hz, sample_rate)
        ok = (refined >= f0_min * 0.9) & (refined <= f0_max * 1.1)
        cand_f0.append(np.where(ok, refined, 0.0))
        cand_score.append(np.where(ok, score, 0.0))
        cand_fund.append(np.where(ok, fund, 0.0))

    if not cand_f0:
        return np.zeros(n_frames, dtype=np.float32)
    R = np.stack(cand_f0)      # (C, T)
    S = np.stack(cand_score)
    Fm = np.stack(cand_fund)
    best = S.max(axis=0)
    # the lowest-octave preference only considers candidates with real
    # energy at their OWN fundamental (>=5% of the frame's spectral
    # peak) — without this, a pure tone at f elects an f/2 subharmonic
    # as soon as the survival margin admits it
    frame_peak = np.maximum(mag.max(axis=1), 1e-12)
    supported = Fm >= 0.05 * frame_peak[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        surv = np.where((S >= margin * np.maximum(best, 1e-9)[None, :])
                        & supported, S, 0.0)
        # fall back to unsupported survivors where none qualify
        surv_any = np.where(
            S >= margin * np.maximum(best, 1e-9)[None, :], S, 0.0)
        none_col = ~(surv > 0).any(axis=0)
        surv = np.where(none_col[None, :], surv_any, surv)
        lowest = np.where(surv > 0, R, np.inf).min(axis=0)
        low_ref = np.where(np.isfinite(lowest), lowest, 1.0)
        close = np.abs(1200.0 * np.log2(
            np.maximum(R, 1e-9) / low_ref[None, :])) < 100.0
        in_class = np.where(close & (surv > 0), surv, 0.0)
    sel = R[in_class.argmax(axis=0), np.arange(n_frames)]
    score = in_class.max(axis=0)
    f0 = np.where((score > score_threshold) & np.isfinite(lowest), sel, 0.0)
    f0 = np.clip(f0, 0.0, f0_max)
    f0 = _octave_repair(f0)
    f0 = _fix_contour(f0, allowed_range=0.12, min_frames=4)
    return _smooth_voiced(f0).astype(np.float32)
