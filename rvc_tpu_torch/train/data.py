"""Training data: dataset rows, bucketed batching, pad-collate (counterpart
of `rvc_tpu/train/data.py`).

Rows of (features, f0, coarse f0, spectrogram, wave, sid); the phone
features repeated 2x to the spectrogram's frame rate; length buckets at
50, 100, ..., 900 frames, every batch padded to its bucket's boundary (a
small closed set of shapes, as the reference's); a shuffle seeded by
seed + epoch. Batches collate to host tensors (pinned where there is a
CUDA device, for an asynchronous copy); the trainer moves them to the
device.

With num_hosts > 1 (one rank a card), every global step groups num_hosts
full batches of one bucket and rank host_id takes member host_id, so every
rank steps as often as the others, at the same padded shape.
"""

from __future__ import annotations

import random
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from rvc_tpu_torch.train.train_step import Batch
from rvc_tpu_torch.utils import audio as audio_utils

BUCKET_BOUNDARIES = tuple(range(50, 950, 50))  # 50..900 frames


class RVCDataset:
    """Loads each row's .npy features and its ground-truth wave on demand."""

    def __init__(self, rows: Sequence[dict], hop_length: int):
        self.rows = list(rows)
        self.hop_length = hop_length

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, i: int) -> Optional[Dict[str, np.ndarray]]:
        """The row's arrays cut to their common frame count, or None for a
        row whose files do not load (skipped, as the reference does)."""
        r = self.rows[i]
        try:
            feats = np.load(r["features"])            # (T_h, 768) at 50 Hz
            f0 = np.load(r["f0"])                      # (T_f,)
            f0c = np.load(r["f0_coarse"])              # (T_f,)
            spec = np.load(r["spec"])                  # (T_s, F)
            wave = audio_utils.to_mono(audio_utils.load_wav(r["audio"])[0])
        except (OSError, ValueError, EOFError):
            return None
        phone = np.repeat(feats, 2, axis=0)            # 2x to 100 Hz
        T = min(phone.shape[0], spec.shape[0], len(f0), len(f0c))
        return dict(phone=phone[:T].astype(np.float32), pitch=f0c[:T].astype(np.int64),
                    pitchf=f0[:T].astype(np.float32), spec=spec[:T].astype(np.float32),
                    wave=wave[: T * self.hop_length].astype(np.float32),
                    sid=int(r["sid"]), length=T)


def _bucket_of(n_frames: int) -> int:
    for b in BUCKET_BOUNDARIES:
        if n_frames <= b:
            return b
    return BUCKET_BOUNDARIES[-1]


class DataLoader:
    """Bucketed, epoch-shuffled batches, each padded to its bucket's boundary."""

    def __init__(self, dataset: RVCDataset, batch_size: int, seed: int = 1234,
                 num_hosts: int = 1, host_id: int = 0, drop_last: bool = True,
                 shuffle: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.drop_last = drop_last
        self.shuffle = shuffle  # False = deterministic batch order
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return max(1, len(self.dataset) // (self.batch_size * self.num_hosts))

    def _batches_indices(self) -> List[List[int]]:
        rng = random.Random(self.seed + self.epoch)
        buckets: Dict[int, List[int]] = {}
        for i, r in enumerate(self.dataset.rows):
            n = r.get("n_frames")
            buckets.setdefault(_bucket_of(BUCKET_BOUNDARIES[-1] if n is None else n),
                               []).append(i)
        if self.num_hosts > 1:
            # a leftover batch on one rank would hang the others in the
            # step's collectives: only whole steps of num_hosts full batches
            steps = []
            for _, idxs in sorted(buckets.items()):
                if self.shuffle:
                    rng.shuffle(idxs)
                full = [idxs[j: j + self.batch_size]
                        for j in range(0, len(idxs) - self.batch_size + 1, self.batch_size)]
                for j in range(0, len(full) - self.num_hosts + 1, self.num_hosts):
                    steps.append(full[j: j + self.num_hosts])
            if self.shuffle:
                rng.shuffle(steps)
            return [step[self.host_id] for step in steps]
        batches = []
        for _, idxs in sorted(buckets.items()):
            if self.shuffle:
                rng.shuffle(idxs)
            for j in range(0, len(idxs), self.batch_size):
                group = idxs[j: j + self.batch_size]
                if len(group) == self.batch_size or not self.drop_last:
                    batches.append(group)
        if self.shuffle:
            rng.shuffle(batches)
        return batches

    def __iter__(self) -> Iterator[Batch]:
        for group in self._batches_indices():
            samples = [self.dataset[i] for i in group]
            if self.num_hosts > 1:
                # B and T must not depend on which rows load on this rank: a
                # row that fails is replaced by a copy of one that loads, and T
                # is the bucket of the rows' metadata
                good = [s for s in samples if s is not None]
                if not good:
                    raise RuntimeError(f"all {len(group)} rows of a batch failed to load on "
                                       f"rank {self.host_id}; clean the dataset (rows {group})")
                samples = [s if s is not None else dict(good[0]) for s in samples]
                n_frames = [self.dataset.rows[i].get("n_frames") for i in group]
                T = _bucket_of(max(BUCKET_BOUNDARIES[-1] if n is None else n for n in n_frames))
            else:
                samples = [s for s in samples if s is not None]
                if not samples:
                    continue
                T = _bucket_of(max(s["length"] for s in samples))
            B = len(samples)
            hop = self.dataset.hop_length
            phone = np.zeros((B, T, samples[0]["phone"].shape[1]), np.float32)
            pitch = np.zeros((B, T), np.int64)
            pitchf = np.zeros((B, T), np.float32)
            spec = np.zeros((B, T, samples[0]["spec"].shape[1]), np.float32)
            wave = np.zeros((B, T * hop), np.float32)
            lengths = np.zeros(B, np.int64)
            sid = np.zeros(B, np.int64)
            for i, s in enumerate(samples):
                n = s["length"]
                phone[i, :n] = s["phone"][:n]
                pitch[i, :n] = s["pitch"][:n]
                pitchf[i, :n] = s["pitchf"][:n]
                spec[i, :n] = s["spec"][:n]
                wave[i, : n * hop] = s["wave"][: n * hop]
                lengths[i] = n
                sid[i] = s["sid"]
            tensors = [torch.from_numpy(a) for a in
                       (phone, lengths, pitch, pitchf, spec, lengths.copy(), wave, sid)]
            if torch.cuda.is_available():
                tensors = [x.pin_memory() for x in tensors]
            yield Batch(*tensors)
