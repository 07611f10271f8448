"""The plain reference of RVC's realtime voice changer, block by block.

A stream arrives at 48 kHz in blocks of `block` samples. Each block is
resampled to 16 kHz and shifted into a circular convert buffer (block +
SOLA search + extra context + crossfade, rounded up to the 10 ms window);
the buffer, reflect-padded to whole buckets, is converted: f0 of the
buffer's tail shifted into a pitch state that rolls left by one block,
HuBERT features of the whole buffer, the synthesizer over the buffer's
frames, `skip` frames of context dropped and `ret` kept, resampled to
48 kHz. SOLA then aligns that audio to the previous block's tail by the
normalised cross-correlation over a 10 ms search and crossfades the two
with sin^2 fades (`sola_crossfade`). A block whose buffer's RMS is under
the gate is returned as zeros after SOLA.

Follows RVC's realtime engine (`rvc/realtime/core.py`); numpy, scipy and
the plain networks of `nets`.
"""

from __future__ import annotations

from math import gcd
from types import SimpleNamespace
from typing import List

import numpy as np
import torch
from scipy import signal as sp_signal
from torch.nn import functional as F

from portbench.reference import dsp
from portbench.reference.offline import BUCKET, WIN, Models, f0_program, noise_rows

AUDIO_SR = 48000
SR = 16000


def resample(x: np.ndarray, orig: int, target: int) -> np.ndarray:
    """Polyphase resampling along the last axis (scipy's resample_poly)."""
    if orig == target:
        return x.astype(np.float32)
    g = gcd(orig, target)
    return sp_signal.resample_poly(x.astype(np.float64), target // g, orig // g,
                                   axis=-1).astype(np.float32)


def geometry(block: int, crossfade: int, search: int, extra: int) -> SimpleNamespace:
    """The 16 kHz buffer of a session whose sizes are given at 48 kHz."""
    to16 = lambda n: int(n / AUDIO_SR * SR)  # noqa: E731
    b16, c16, s16, e16 = to16(block), to16(crossfade), to16(search), to16(extra)
    size = b16 + s16 + e16 + c16
    size += (-size) % WIN
    skip = e16 // WIN
    return SimpleNamespace(block16=b16, cross16=c16, size=size, frames=size // WIN, skip=skip,
                           ret=size // WIN - skip, silence_front=max(skip - 5, 0))


def sola_crossfade(audio: np.ndarray, sola_buffer: np.ndarray, fade_in: np.ndarray,
                   fade_out: np.ndarray, block: int, search: int) -> np.ndarray:
    """One stream's SOLA step: align `audio` to the previous tail
    `sola_buffer` at the argmax of the normalised cross-correlation over
    `search` positions, crossfade, keep the new tail in `sola_buffer` (in
    place), return `block` samples."""
    cross = len(sola_buffer)
    n = cross + search
    if len(audio) < n:
        audio = np.pad(audio, (0, n - len(audio)))
    head = audio[:n]
    nom = sp_signal.correlate(head, sola_buffer, mode="valid")
    den = np.sqrt(sp_signal.correlate(head ** 2, np.ones(cross), mode="valid") + 1e-8)
    audio = audio[int(np.argmax(nom / den)):].copy()
    if len(audio) < block + cross:
        audio = np.pad(audio, (0, block + cross - len(audio)))
    audio[:cross] = audio[:cross] * fade_in + sola_buffer * fade_out
    sola_buffer[:] = audio[block: block + cross]
    return audio[:block]


class Streams:
    """Reference streams `rows` of a pool of `pool_size` (the row picks the
    NSF source noise of the pool's dispatch), speaker ids `sids`."""

    def __init__(self, m: Models, rows: List[int], pool_size: int, sids: List[int], block: int,
                 crossfade_s: float, extra_s: float, gate_db: float):
        self.m, self.rows, self.pool_size = m, list(rows), pool_size
        self.sids = torch.tensor(sids, device=next(m.synth.parameters()).device)
        self.block = block
        self.search = AUDIO_SR // 100
        self.g = geometry(block, int(crossfade_s * AUDIO_SR), self.search,
                          int(extra_s * AUDIO_SR))
        n = len(rows)
        self.convert = np.zeros((n, self.g.size), np.float32)
        self.audio = np.zeros((n, self.g.block16 + self.g.cross16), np.float32)
        self.pitchf = torch.zeros((n, self.g.frames), device=self.sids.device)
        self.gate = 10 ** (gate_db / 20)

    @staticmethod
    def _shift(buf: np.ndarray, data: np.ndarray) -> None:
        k = data.shape[1]
        if k >= buf.shape[1]:
            buf[:] = data[:, -buf.shape[1]:]
        else:
            buf[:, :-k] = buf[:, k:]
            buf[:, -k:] = data

    @torch.inference_mode()
    def convert_step(self, blocks48: np.ndarray):
        """(the streams' converted audio before SOLA (n, samples) at 48 kHz,
        their gate volumes (n,))."""
        g, m = self.g, self.m
        a16 = resample(blocks48, AUDIO_SR, SR)
        self._shift(self.audio, a16)
        self._shift(self.convert, a16)
        vols = np.sqrt(np.mean(self.audio ** 2, axis=1))
        b = BUCKET * WIN
        pad = -(-g.size // b) * b - g.size
        buf = np.pad(self.convert, ((0, 0), (0, pad)), mode="reflect") if pad else self.convert
        x = torch.from_numpy(np.ascontiguousarray(buf)).to(self.sids.device)
        f0 = f0_program(m.rmvpe, x[:, g.silence_front * WIN: g.size])
        bf = g.block16 // WIN
        self.pitchf = torch.cat([self.pitchf[:, bf: bf + (g.frames - f0.shape[1])], f0], dim=1)
        feats = m.hubert(x)
        t_feat = feats.shape[1] * 2
        pf = self.pitchf[:, :t_feat]
        if t_feat > g.frames:
            pf = F.pad(pf, (0, t_feat - g.frames))
        length = min(g.frames, t_feat)
        noise = noise_rows(self.pool_size, t_feat * m.upp, x.device)[self.rows]
        lengths = torch.full((len(self.rows),), length, device=x.device)
        wave = m.synth.infer(feats.repeat_interleave(2, dim=1), lengths, dsp.coarse_f0(pf), pf,
                             self.sids, noise)
        spf = m.sr // 100
        wave = wave[:, g.skip * spf: (g.skip + g.ret) * spf].cpu().numpy()
        return resample(wave, m.sr, AUDIO_SR), vols
