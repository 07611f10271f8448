"""RMS-silence-based audio slicer (a copy of `rvc_tpu/preprocess/slicer.py`,
host numpy; the port imports nothing of `rvc_tpu`).

Capability parity with `rvc/train/preprocess/slicer.py` /
`rvc_mlx/preprocess/audio_slicer.py`: frame RMS in dB against a
threshold, split at silences >= min_interval, enforce min_length,
keep at most max_sil_kept of silence at segment edges.
"""

from __future__ import annotations

from typing import List

import numpy as np


def _frame_rms(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    pad = frame_length // 2
    a = np.pad(y, (pad, pad))
    n = 1 + (len(a) - frame_length) // hop_length
    idx = np.arange(frame_length)[None, :] + hop_length * np.arange(n)[:, None]
    return np.sqrt(np.mean(a[idx] ** 2, axis=1))


class Slicer:
    def __init__(
        self,
        sr: int,
        threshold: float = -40.0,
        min_length: int = 5000,
        min_interval: int = 300,
        hop_size: int = 20,
        max_sil_kept: int = 5000,
    ):
        if not min_length >= min_interval >= hop_size:
            raise ValueError("min_length >= min_interval >= hop_size required")
        if max_sil_kept < hop_size:
            raise ValueError("max_sil_kept >= hop_size required")
        self.sr = sr
        self.threshold = 10 ** (threshold / 20.0)
        self.hop_size = round(sr * hop_size / 1000)
        self.win_size = min(round(sr * min_interval / 1000), 4 * self.hop_size)
        self.min_length = round(sr * min_length / 1000 / self.hop_size)
        self.min_interval = round(min_interval / hop_size)
        self.max_sil_kept = round(sr * max_sil_kept / 1000 / self.hop_size)

    def _apply(self, waveform: np.ndarray, begin: int, end: int) -> np.ndarray:
        start = begin * self.hop_size
        stop = min(len(waveform), end * self.hop_size)
        return waveform[start:stop]

    def slice(self, waveform: np.ndarray) -> List[np.ndarray]:
        samples = waveform if waveform.ndim == 1 else waveform.mean(axis=1)
        if samples.shape[0] <= self.min_length * self.hop_size:
            return [waveform]
        rms = _frame_rms(samples, self.win_size, self.hop_size)

        sil_tags = []
        silence_start = None
        clip_start = 0
        for i, r in enumerate(rms):
            if r < self.threshold:
                if silence_start is None:
                    silence_start = i
                continue
            if silence_start is None:
                continue
            is_leading = silence_start == 0
            need_split = (i - silence_start >= self.min_interval
                          and i - clip_start >= self.min_length)
            if not is_leading and not need_split:
                silence_start = None
                continue
            if i - silence_start <= self.max_sil_kept:
                pos = int(rms[silence_start : i + 1].argmin()) + silence_start
                sil_tags.append((0, pos) if silence_start == 0 else (pos, pos))
                clip_start = pos
            else:
                pos_l = int(rms[silence_start : silence_start + self.max_sil_kept + 1].argmin()) + silence_start
                pos_r = int(rms[i - self.max_sil_kept : i + 1].argmin()) + i - self.max_sil_kept
                if silence_start == 0:
                    sil_tags.append((0, pos_r))
                else:
                    sil_tags.append((pos_l, pos_r))
                clip_start = pos_r
            silence_start = None

        total = len(rms)
        if silence_start is not None and total - silence_start >= self.min_interval:
            sil_end = min(total, silence_start + self.max_sil_kept)
            pos = int(rms[silence_start : sil_end + 1].argmin()) + silence_start
            sil_tags.append((pos, total + 1))

        if not sil_tags:
            return [waveform]
        chunks = []
        if sil_tags[0][0] > 0:
            chunks.append(self._apply(waveform, 0, sil_tags[0][0]))
        for i in range(len(sil_tags) - 1):
            chunks.append(self._apply(waveform, sil_tags[i][1], sil_tags[i + 1][0]))
        if sil_tags[-1][1] < total:
            chunks.append(self._apply(waveform, sil_tags[-1][1], total))
        return [c for c in chunks if len(c) > 0]
