"""Silence-based audio splitting + merging (a copy of
`rvc_tpu/utils/split_audio.py`, host numpy; the port imports nothing of
`rvc_tpu`).

Capability parity with `rvc/lib/tools/split_audio.py:5,29` (used by
`VoiceConverter.convert_audio(split_audio=True)`): detect non-silent
intervals, convert each separately, merge back preserving the original
silence gaps.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _frame_db(audio: np.ndarray, frame: int, hop: int) -> np.ndarray:
    pad = frame // 2
    a = np.pad(audio, (pad, pad))
    n = 1 + (len(a) - frame) // hop
    idx = np.arange(frame)[None, :] + hop * np.arange(n)[:, None]
    rms = np.sqrt(np.mean(a[idx] ** 2, axis=1))
    return 20 * np.log10(np.maximum(rms, 1e-10))


def split_silence_nonsilent(
    audio: np.ndarray,
    sr: int,
    min_silence_ms: int = 500,
    silence_thresh_db: float = -40.0,
    keep_silence_ms: int = 100,
) -> Tuple[List[Tuple[int, int]], List[np.ndarray]]:
    """Returns ([(start, end) sample intervals of speech], [segments])."""
    hop = sr // 100
    frame = 2 * hop
    db = _frame_db(np.asarray(audio, np.float32), frame, hop)
    silent = db < silence_thresh_db
    min_frames = max(1, min_silence_ms // 10)
    keep = keep_silence_ms * sr // 1000

    # find runs of silence >= min_frames
    intervals = []
    start = None
    i = 0
    n = len(silent)
    while i < n:
        if not silent[i]:
            if start is None:
                start = i
            i += 1
            continue
        # count the run of silence
        j = i
        while j < n and silent[j]:
            j += 1
        if start is not None and (j - i) >= min_frames:
            intervals.append((start, i))
            start = None
        i = j
    if start is not None:
        intervals.append((start, n))

    out = []
    segs = []
    for (s, e) in intervals:
        ss = max(0, s * hop - keep)
        ee = min(len(audio), e * hop + keep)
        out.append((ss, ee))
        segs.append(audio[ss:ee])
    if not out:
        out = [(0, len(audio))]
        segs = [audio]
    return out, segs


def merge_audio(
    intervals: List[Tuple[int, int]],
    converted: List[np.ndarray],
    total_len: int,
    sr_in: int,
    sr_out: int,
) -> np.ndarray:
    """Place converted segments back at their (rate-scaled) positions,
    silence in the gaps."""
    scale = sr_out / sr_in
    out = np.zeros(int(total_len * scale) + 1, dtype=np.float32)
    for (s, e), seg in zip(intervals, converted):
        ss = int(s * scale)
        out[ss : ss + len(seg)] = seg[: max(0, len(out) - ss)]
    return out
