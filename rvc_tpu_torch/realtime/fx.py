"""Post-processing FX chain (a copy of `rvc_tpu/realtime/fx.py`, host
numpy and scipy; the port imports nothing of `rvc_tpu`).

Native replacement for the pedalboard (JUCE C++) chain the reference
wires in (`rvc_mlx/realtime/core.py:86-144`; same flag surface as
`rvc_cli.py`'s post_process options): reverb, pitch shift, limiter,
gain, distortion, chorus, bitcrush, clipping, compressor, delay. DSP in
vectorized numpy/scipy — streaming-safe (stateless per block except
where noted).
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np
from scipy import signal as sp


def gain_fx(gain_db: float = 0.0):
    g = 10 ** (gain_db / 20)
    return lambda x, sr: x * g


def distortion_fx(drive_db: float = 25.0):
    drive = 10 ** (drive_db / 20)
    return lambda x, sr: np.tanh(x * drive)


def clipping_fx(threshold_db: float = 0.0):
    t = 10 ** (threshold_db / 20)
    return lambda x, sr: np.clip(x, -t, t)


def bitcrush_fx(bit_depth: int = 8):
    def fn(x, sr):
        levels = 2 ** bit_depth
        return np.round(x * (levels / 2)) / (levels / 2)
    return fn


def limiter_fx(threshold_db: float = -6.0, release_ms: float = 50.0):
    thresh = 10 ** (threshold_db / 20)

    def fn(x, sr):
        env = np.abs(x)
        # one-pole release smoothing of the gain-reduction envelope
        alpha = np.exp(-1.0 / (sr * release_ms / 1000.0 + 1e-9))
        smooth = sp.lfilter([1 - alpha], [1, -alpha], np.maximum(env, thresh))
        gain = thresh / np.maximum(smooth, thresh)
        return x * gain
    return fn


def compressor_fx(threshold_db: float = 0.0, ratio: float = 1.0,
                  attack_ms: float = 1.0, release_ms: float = 100.0):
    def fn(x, sr):
        if ratio <= 1.0:
            return x
        eps = 1e-9
        level_db = 20 * np.log10(np.abs(x) + eps)
        over = np.maximum(level_db - threshold_db, 0.0)
        gr_db = over * (1.0 - 1.0 / ratio)
        a_att = np.exp(-1.0 / (sr * attack_ms / 1000.0 + eps))
        a_rel = np.exp(-1.0 / (sr * release_ms / 1000.0 + eps))
        sm = np.zeros_like(gr_db)
        state = 0.0
        # ballistic smoothing (attack faster than release)
        for i in range(len(gr_db)):
            a = a_att if gr_db[i] > state else a_rel
            state = a * state + (1 - a) * gr_db[i]
            sm[i] = state
        return x * 10 ** (-sm / 20)
    return fn


def delay_fx(delay_seconds: float = 0.5, feedback: float = 0.0, mix: float = 0.5):
    def fn(x, sr):
        d = max(1, int(delay_seconds * sr))
        out = x.copy()
        wet = np.zeros_like(x)
        src = x.copy()
        fb = 1.0
        for _ in range(8):
            delayed = np.concatenate([np.zeros(d, dtype=x.dtype), src[:-d]]) if d < len(src) else np.zeros_like(src)
            wet += fb * delayed
            src = delayed
            fb *= feedback
            if fb < 1e-3:
                break
        return out * (1 - mix) + wet * mix
    return fn


def chorus_fx(rate_hz: float = 1.0, depth: float = 0.25,
              centre_delay_ms: float = 7.0, feedback: float = 0.0,
              mix: float = 0.5):
    def fn(x, sr):
        n = len(x)
        t = np.arange(n)
        centre = centre_delay_ms * sr / 1000.0
        lfo = centre * (1.0 + depth * np.sin(2 * np.pi * rate_hz * t / sr))
        idx = np.clip(t - lfo, 0, n - 1)
        lo = np.floor(idx).astype(int)
        hi = np.minimum(lo + 1, n - 1)
        frac = idx - lo
        wet = x[lo] * (1 - frac) + x[hi] * frac
        return x * (1 - mix) + wet * mix
    return fn


def _wsola_stretch(x: np.ndarray, sr: int, rate: float,
                   win_s: float = 0.05, tol_s: float = 0.0075) -> np.ndarray:
    """Waveform-similarity overlap-add time stretch (duration / rate,
    pitch preserved). Each synthesis frame's analysis position is
    refined within +-tol by cross-correlation against the natural
    continuation of the previous frame, so harmonic phase stays aligned
    across the overlap — the standard WSOLA construction."""
    if abs(rate - 1.0) < 1e-9 or len(x) == 0:
        return x.copy()
    W = max(256, int(round(win_s * sr)) & ~1)  # even window
    H = W // 2                                 # synthesis hop (50% OLA)
    tol = max(1, int(round(tol_s * sr)))
    win = np.hanning(W).astype(np.float64)
    n_out = int(round(len(x) / rate))
    n_frames = max(1, (n_out - W) // H + 1)
    xp = np.pad(x.astype(np.float64), (tol, W + tol))
    out = np.zeros(n_out + W, dtype=np.float64)
    norm = np.zeros(n_out + W, dtype=np.float64)

    # natural continuation of the previously committed frame: the
    # segment that WOULD follow it in the input, advanced by H
    prev_start = tol  # position in xp of frame 0 (delta = 0)
    for k in range(n_frames):
        nominal = int(round(k * H * rate)) + tol
        if k == 0:
            start = nominal
        else:
            target = xp[prev_start + H : prev_start + H + W]
            lo = max(nominal - tol, 0)
            seg = xp[lo : nominal + tol + W]
            # NORMALIZED cross-correlation: divide by each candidate
            # window's L2 norm so the pick is best waveform similarity,
            # not highest energy (unnormalized CC biases toward loud
            # lags on amplitude-modulated speech)
            cc = np.correlate(seg, target, mode="valid")
            e = np.cumsum(np.concatenate(([0.0], seg * seg)))
            seg_norm = np.sqrt(np.maximum(e[W:] - e[:-W], 1e-12))
            start = lo + int(np.argmax(cc / seg_norm[: len(cc)]))
        frame = xp[start : start + W]
        pos = k * H
        out[pos : pos + W] += frame * win
        norm[pos : pos + W] += win
        prev_start = start
    out = out[:n_out] / np.maximum(norm[:n_out], 1e-8)
    return out.astype(x.dtype, copy=False)


def pitch_shift_fx(semitones: float = 0.0):
    """Pedalboard-PitchShift equivalent (`rvc/infer/infer.py:146-148`):
    shift pitch by `semitones` while preserving duration — WSOLA
    time-stretch by the pitch ratio, then polyphase resample back to the
    original length (rational approximation error < 0.2 cents)."""
    from fractions import Fraction

    def fn(x, sr):
        if abs(semitones) < 1e-6:
            return x
        r = 2.0 ** (semitones / 12.0)
        y = _wsola_stretch(np.asarray(x, dtype=np.float32), sr, 1.0 / r)
        frac = Fraction(1.0 / r).limit_denominator(256)
        y = sp.resample_poly(y, frac.numerator, frac.denominator)
        # exact length restore (rational rounding leaves a few samples)
        if len(y) >= len(x):
            return y[: len(x)].astype(np.float32)
        return np.pad(y, (0, len(x) - len(y))).astype(np.float32)

    return fn


def reverb_fx(room_size: float = 0.5, damping: float = 0.5,
              wet_level: float = 0.33, dry_level: float = 0.4,
              width: float = 1.0, freeze_mode: float = 0.0):
    """Freeverb-style: 4 feedback comb filters + 2 allpasses."""
    comb_delays_ms = (29.7, 37.1, 41.1, 43.7)
    allpass_delays_ms = (5.0, 1.7)

    def fn(x, sr):
        fb = 0.7 + 0.28 * room_size
        damp = damping * 0.4
        wet = np.zeros_like(x)
        for dm in comb_delays_ms:
            d = max(1, int(dm * sr / 1000))
            b = np.zeros(d + 1)
            b[0] = 1.0
            a = np.zeros(d + 1)
            a[0] = 1.0
            a[d] = -fb * (1 - damp)
            wet += sp.lfilter(b, a, x)
        wet /= len(comb_delays_ms)
        for dm in allpass_delays_ms:
            d = max(1, int(dm * sr / 1000))
            b = np.zeros(d + 1)
            a = np.zeros(d + 1)
            b[0], b[d] = -0.5, 1.0
            a[0], a[d] = 1.0, -0.5
            wet = sp.lfilter(b, a, wet)
        return (dry_level * x + wet_level * wet).astype(x.dtype)
    return fn


class FXChain:
    def __init__(self, effects: List[Callable]):
        self.effects = effects

    def __call__(self, x: np.ndarray, sr: int) -> np.ndarray:
        x = np.asarray(x, dtype=np.float32)
        for fx in self.effects:
            x = np.asarray(fx(x, sr), dtype=np.float32)
        return x


def build_fx_chain(**kwargs) -> FXChain:
    """Same flag surface as the reference's `setup_pedalboard`."""
    fx = []
    if kwargs.get("reverb"):
        fx.append(reverb_fx(
            kwargs.get("reverb_room_size", 0.5), kwargs.get("reverb_damping", 0.5),
            kwargs.get("reverb_wet_level", 0.33), kwargs.get("reverb_dry_level", 0.4),
            kwargs.get("reverb_width", 1.0), kwargs.get("reverb_freeze_mode", 0)))
    if kwargs.get("pitch_shift"):
        # reference chain order: PitchShift sits between reverb and
        # limiter (`rvc/infer/infer.py:146-148`)
        fx.append(pitch_shift_fx(kwargs.get("pitch_shift_semitones", 0.0)))
    if kwargs.get("limiter"):
        fx.append(limiter_fx(kwargs.get("limiter_threshold", -6),
                             kwargs.get("limiter_release", 50)))
    if kwargs.get("gain"):
        fx.append(gain_fx(kwargs.get("gain_db", 0)))
    if kwargs.get("distortion"):
        fx.append(distortion_fx(kwargs.get("distortion_gain", 25)))
    if kwargs.get("chorus"):
        fx.append(chorus_fx(
            kwargs.get("chorus_rate", 1.0), kwargs.get("chorus_depth", 0.25),
            kwargs.get("chorus_delay", 7), kwargs.get("chorus_feedback", 0.0),
            kwargs.get("chorus_mix", 0.5)))
    if kwargs.get("bitcrush"):
        fx.append(bitcrush_fx(kwargs.get("bitcrush_bit_depth", 8)))
    if kwargs.get("clipping"):
        fx.append(clipping_fx(kwargs.get("clipping_threshold", 0)))
    if kwargs.get("compressor"):
        fx.append(compressor_fx(
            kwargs.get("compressor_threshold", 0), kwargs.get("compressor_ratio", 1),
            kwargs.get("compressor_attack", 1.0), kwargs.get("compressor_release", 100)))
    if kwargs.get("delay"):
        fx.append(delay_fx(
            kwargs.get("delay_seconds", 0.5), kwargs.get("delay_feedback", 0.0),
            kwargs.get("delay_mix", 0.5)))
    return FXChain(fx)
