"""Dataset audio preprocessor (a copy of `rvc_tpu/preprocess/preprocessor.py`,
host numpy and scipy; the port imports nothing of `rvc_tpu`).

Capability parity with `rvc/train/preprocess/preprocess.py:37-243`:
slices input recordings (Skip / Simple fixed chunks / Automatic
silence-slicer with 3.7 s + 0.3 s-overlap windowing), alpha-blend peak
normalization (0.9 max, alpha 0.75), and dual-rate output (target sr for
training spectrograms + 16 kHz for feature extraction).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from rvc_tpu_torch.preprocess.slicer import Slicer
from rvc_tpu_torch.utils import audio as audio_utils

PERCENTAGE = 3.7     # seconds per automatic-mode chunk
OVERLAP = 0.3        # seconds of overlap
MAX_AMPLITUDE = 0.9
ALPHA = 0.75
SAMPLE_RATE_16K = 16000


def normalize_audio(audio: np.ndarray) -> Optional[np.ndarray]:
    tmp_max = np.abs(audio).max()
    if tmp_max > 2.5:
        return None  # clipped/broken sample, filtered out
    return (audio / tmp_max * (MAX_AMPLITUDE * ALPHA)) + (1 - ALPHA) * audio


class AudioPreprocessor:
    def __init__(self, exp_dir: str, sr: int):
        self.exp_dir = exp_dir
        self.sr = sr
        self.gt_wavs_dir = os.path.join(exp_dir, "sliced_audios")
        self.wavs16k_dir = os.path.join(exp_dir, "sliced_audios_16k")
        os.makedirs(self.gt_wavs_dir, exist_ok=True)
        os.makedirs(self.wavs16k_dir, exist_ok=True)
        self.slicer = Slicer(sr=sr, threshold=-42, min_length=1500,
                             min_interval=400, hop_size=15, max_sil_kept=500)

    def _write_pair(self, audio: np.ndarray, sid: int, idx0: int, idx1) -> None:
        name = f"{sid}_{idx0}_{idx1}.wav"
        audio_utils.save_wav(os.path.join(self.gt_wavs_dir, name), audio,
                             self.sr, subtype="FLOAT")
        a16 = audio_utils.resample(audio, self.sr, SAMPLE_RATE_16K)
        audio_utils.save_wav(os.path.join(self.wavs16k_dir, name), a16,
                             SAMPLE_RATE_16K, subtype="FLOAT")

    def process_file(
        self,
        path: str,
        sid: int,
        idx0: int,
        cut_preprocess: str = "Automatic",
        process_effects: bool = True,
        chunk_len: float = 3.0,
        overlap_len: float = 0.3,
        noise_reduction: bool = False,
        noise_reduction_strength: float = 0.7,
    ) -> int:
        """Returns the number of segments written."""
        audio = audio_utils.load_audio(path, self.sr)
        if process_effects:
            audio = audio_utils.highpass_filter(audio, self.sr, 48.0, 5)
        if noise_reduction:
            # reference gates this behind --noise_reduction
            # (`rvc/train/preprocess/preprocess.py` noisereduce pass)
            from rvc_tpu_torch.utils.noise import reduce_noise

            audio = reduce_noise(audio, self.sr, noise_reduction_strength)
        count = 0
        if cut_preprocess == "Skip":
            a = normalize_audio(audio)
            if a is not None:
                self._write_pair(a, sid, idx0, 0)
                count += 1
        elif cut_preprocess == "Simple":
            chunk_n = int(self.sr * chunk_len)
            overlap_n = int(self.sr * overlap_len)
            i = 0
            while i < len(audio):
                chunk = audio[i : i + chunk_n]
                if len(chunk) == chunk_n:
                    a = normalize_audio(chunk)
                    if a is not None:
                        self._write_pair(a, sid, idx0, i // (chunk_n - overlap_n))
                        count += 1
                i += chunk_n - overlap_n
        else:  # Automatic
            for seg_idx, seg in enumerate(self.slicer.slice(audio)):
                # window into PERCENTAGE-second chunks with OVERLAP step-back
                i = 0
                while True:
                    start = int(self.sr * (PERCENTAGE - OVERLAP) * i)
                    i += 1
                    if len(seg[start:]) > (PERCENTAGE + OVERLAP) * self.sr:
                        chunk = seg[start : start + int(PERCENTAGE * self.sr)]
                        a = normalize_audio(chunk)
                        if a is not None:
                            self._write_pair(a, sid, idx0, f"{seg_idx}_{i - 1}")
                            count += 1
                    else:
                        chunk = seg[start:]
                        if len(chunk) > 0.3 * self.sr:
                            a = normalize_audio(chunk)
                            if a is not None:
                                self._write_pair(a, sid, idx0, f"{seg_idx}_{i - 1}")
                                count += 1
                        break
        return count

    def process_directory(self, dataset_path: str, cut_preprocess: str = "Automatic",
                          cpu_cores: int = 1, **kwargs) -> int:
        """Process every audio file; speaker id from `spk_id` subdirs if
        present, else 0. cpu_cores > 1 fans the file loop out over a
        process pool (spawned) (the reference's `cpu_cores` workers,
        `rvc/train/preprocess/preprocess.py:271`) — slicing/filtering is
        pure numpy/scipy, embarrassingly parallel per file."""
        files = []
        for root, _, names in os.walk(dataset_path):
            for n in sorted(names):
                if os.path.splitext(n)[1].lower() in (".wav", ".flac", ".mp3", ".ogg"):
                    files.append(os.path.join(root, n))
        files = sorted(files)

        def sid_of(f):
            rel = os.path.relpath(os.path.dirname(f), dataset_path)
            return int(rel) if rel.isdigit() else 0

        jobs = [(f, sid_of(f), idx0, cut_preprocess, kwargs)
                for idx0, f in enumerate(files)]
        if cpu_cores <= 1 or len(jobs) <= 1:
            return sum(self._run_job(j) for j in jobs)

        import multiprocessing as mp

        # spawn: the parent may hold torch's threads, which fork would copy
        # in whatever state they are in
        ctx = mp.get_context("spawn")
        with ctx.Pool(min(cpu_cores, len(jobs))) as pool:
            counts = pool.map(self._run_job, jobs, chunksize=1)
        return sum(counts)

    def _run_job(self, job) -> int:
        f, sid, idx0, cut_preprocess, kwargs = job
        return self.process_file(f, sid, idx0, cut_preprocess, **kwargs)
