"""The benchmark's one generator of input audio and its length sets.

`voice(seconds, params, seed, device)` renders a seeded voice track: phrases
separated by pauses at a noise floor; in a phrase an f0 that glides between
notes drawn in `f0_hz`, with vibrato, `harmonics` partials falling as
1 / h, a syllable-rate envelope and breath noise. The phrase structure is
drawn on the host (numpy, from the seed), the samples rendered on `device`
in a few tensor operations. A traffic file's `voice` object gives the
parameters; its length rule gives the set of lengths (`lengths`), which is
the same for every seed: the seed only orders them and draws the content.
Patterned after `chip_smoke.py`'s `test_clip` / `synth_utterances`.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

SR = 16000


def lengths(rule: Dict, seed: int) -> List[float]:
    """The lengths in seconds of a traffic's items, a fixed set in an order
    drawn from the seed. rule: {"count", "dist": "lognormal" (median,
    sigma, clip) or "uniform" (low, high)}; the set is the distribution's
    quantiles at (i + 0.5) / count."""
    n = int(rule["count"])
    q = (np.arange(n) + 0.5) / n
    if rule["dist"] == "lognormal":
        from scipy.stats import norm

        x = rule["median"] * np.exp(rule["sigma"] * norm.ppf(q))
        x = np.clip(x, *rule["clip"])
    elif rule["dist"] == "uniform":
        x = rule["low"] + (rule["high"] - rule["low"]) * q
    else:
        raise ValueError(f"unknown length rule {rule['dist']!r}")
    order = rng(seed, 1).permutation(n)
    return [float(round(v, 2)) for v in x[order]]


def rng(seed: int, stream: int) -> np.random.Generator:
    """numpy's generator for one stream of draws of a (large) seed."""
    return np.random.default_rng([int(seed) & 0xFFFFFFFFFFFF, stream])


def voice(seconds: float, p: Dict, seed: int, device, sr: int = SR, with_f0: bool = False):
    """A seeded voice track of `seconds` at `sr`, float32 (n,) on `device`;
    with_f0 also its f0 per sample (0 where no phrase sounds).

    p: phrase_s [lo, hi], pause_s [lo, hi], f0_hz [lo, hi], note_s [lo, hi],
    vibrato_hz [lo, hi], vibrato_semitones, harmonics, level, breath,
    floor_db."""
    draw = rng(seed, 2)
    n = int(round(seconds * sr))
    # phrase structure: (start, end) sample bounds, then notes inside each
    starts, ends = [], []
    t = draw.uniform(*p["pause_s"]) * 0.5
    while t < seconds:
        d = draw.uniform(*p["phrase_s"])
        starts.append(t)
        ends.append(min(t + d, seconds))
        t += d + draw.uniform(*p["pause_s"])
    knots_t, knots_f = [0.0], [draw.uniform(*p["f0_hz"])]
    for s, e in zip(starts, ends):
        u = s
        while u < e:
            knots_t.append(u)
            knots_f.append(math.exp(draw.uniform(*np.log(p["f0_hz"]))))
            u += draw.uniform(*p["note_s"])
    knots_t.append(seconds + 1.0)
    knots_f.append(knots_f[-1])
    vib_hz = draw.uniform(*p["vibrato_hz"])
    syll_hz = draw.uniform(3.0, 5.0)
    phase0 = draw.uniform(0, 2 * math.pi, size=int(p["harmonics"]))

    f32 = dict(dtype=torch.float32, device=device)
    tt = torch.arange(n, dtype=torch.float64, device=device) / sr
    kt = torch.tensor(knots_t, dtype=torch.float64, device=device)
    kf = torch.tensor(np.log(knots_f), dtype=torch.float64, device=device)
    # glide: log-f0 moves to each note over its first 30%, then holds
    j = torch.clamp(torch.searchsorted(kt, tt, right=True) - 1, 0, len(knots_t) - 2)
    frac = torch.clamp((tt - kt[j]) / (0.3 * (kt[j + 1] - kt[j])), 0.0, 1.0)
    prev = kf[torch.clamp(j - 1, min=0)]
    logf = prev + (kf[j] - prev) * (0.5 - 0.5 * torch.cos(math.pi * frac))
    semis = p["vibrato_semitones"] * torch.sin(2 * math.pi * vib_hz * tt)
    f0 = torch.exp(logf) * torch.pow(2.0, semis / 12.0)
    phase = 2 * math.pi * torch.cumsum(f0 / sr, dim=0)
    harm = torch.arange(1, int(p["harmonics"]) + 1, dtype=torch.float64, device=device)
    tone = torch.zeros(n, dtype=torch.float64, device=device)
    for h, ph in zip(harm, phase0):
        tone += torch.sin(h * phase + float(ph)) / h
    # phrase envelope: 40 ms attack, 80 ms release, a syllable-rate swell
    env = torch.zeros(n, dtype=torch.float64, device=device)
    for s, e in zip(starts, ends):
        a = torch.clamp((tt - s) / 0.04, 0, 1) * torch.clamp((e - tt) / 0.08, 0, 1)
        env = torch.maximum(env, a)
    env = env * (0.75 + 0.25 * torch.sin(2 * math.pi * syll_hz * tt) ** 2)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(draw.integers(1 << 62)))
    noise = torch.randn(n, generator=gen, **f32).double()
    floor = 10.0 ** (p["floor_db"] / 20.0)
    y = p["level"] * env * (tone / harm.reciprocal().sum() + p["breath"] * noise) + floor * noise
    if with_f0:
        return y.float(), torch.where(env > 0, f0, torch.zeros_like(f0)).float()
    return y.float()


def voices(seconds: Sequence[float], p: Dict, seed: int, device,
           sr: int = SR) -> List[np.ndarray]:
    """One voice track per length, item i seeded from (seed, i), as host
    float32 arrays at `sr`."""
    return [voice(s, p, seed * 1000003 + i, device, sr=sr).cpu().numpy()
            for i, s in enumerate(seconds)]
