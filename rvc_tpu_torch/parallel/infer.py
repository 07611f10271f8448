"""Batched and long-form conversion (counterpart of `rvc_tpu/parallel/infer.py`).

`BatchConverter(rvc)` converts batches of equal-length 16 kHz utterances on
`rvc.device`, as the reference's two programs do on one device (its mesh's
"data" axis is 1 on one card, so a batch is one dispatch):

    pad T to a multiple of 320 -> f0 program: log-mel [K4] -> RMVPE ->
    decode -> range gate -> semitone shift -> HuBERT -> edge pad to
    (T // 160 + 1) // 2 frames -> f0 cut or padded to 2x that ->
    2x upsample + protect (no retrieval) -> Synthesizer.infer [K3, K1, K2]
    over full lengths

with no high-pass, reflect pad or bucket pad, and no autotune. The pieces
are `Pipeline`'s (`f0`, `_features`, `_synthesize`); the source noise is
one generator seeded 0x5EED per dispatch, as in `Pipeline`. Audio goes in
and comes out float32. The reference's bf16 / f16 transfer policy is TPU
dispatch machinery and is not ported.

`convert_long_batch` cuts every utterance into windows of chunk + 2 pad
seconds of the reflect-padded utterance, queues every group of
`batch_size` windows on the card before it reads any back (the last group
padded with repeats of its last window), then copies the groups to the
host in order and reassembles each utterance from its trimmed windows.
The copies wait behind the whole queue on the one stream; they move 4
bytes a sample at the target rate, which is small beside the groups'
compute, so no side stream overlaps them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
from torch.nn import functional as F

from rvc_tpu_torch.pipelines.offline import SAMPLE_RATE, WINDOW, coarse_f0_torch
from rvc_tpu_torch.utils.device import to_device


class BatchConverter:
    """Converts equal-length utterance batches with `rvc`'s models
    (`rvc_tpu_torch.api.RVC`), on its device."""

    def __init__(self, rvc):
        self.rvc = rvc
        self.device = rvc.device

    @torch.inference_mode()
    def convert_batch(self, audio_batch: np.ndarray, sids: Optional[np.ndarray] = None,
                      pitch_shift: float = 0.0, protect: float = 0.5, defer: bool = False):
        """Convert one equal-length batch (B, T) of 16 kHz audio -> (B,
        (T padded to 320) * tgt_sr / 16000) float32 at the model's rate.
        sids: (B,) speaker ids (0 when None). With defer=True the device
        tensor is returned without waiting for it."""
        p = self.rvc.pipeline
        B, T = audio_batch.shape
        pad = (-T) % (WINDOW * 2)
        audio_batch = np.asarray(audio_batch, dtype=np.float32)
        if pad:
            audio_batch = np.pad(audio_batch, ((0, 0), (0, pad)))
        audio = to_device(audio_batch, self.device)
        sid = to_device(np.asarray(sids if sids is not None else np.zeros(B), np.int64),
                        self.device)
        f0 = p.f0(audio, pitch_shift, 0.0)
        p_len0 = audio.shape[1] // WINDOW
        feats, _ = p._features(audio, p_len0, None, 0.0)
        t_feat = feats.shape[1] * 2
        f0 = f0[:, :t_feat] if p_len0 >= t_feat else F.pad(f0, (0, t_feat - p_len0))
        lengths = torch.full((B,), t_feat, dtype=torch.int64, device=self.device)
        wave = p._synthesize(feats, feats, lengths, sid, protect, coarse_f0_torch(f0), f0)
        return wave if defer else wave.cpu().numpy()

    def convert_long_batch(self, utterances: Sequence[np.ndarray],
                           sids: Optional[Sequence[int]] = None, chunk_seconds: float = 10.0,
                           pad_seconds: float = 1.0, batch_size: Optional[int] = None,
                           **kwargs) -> List[np.ndarray]:
        """Batched long-form conversion: each utterance (T_i,) at 16 kHz ->
        (int(T_i * tgt_sr / 16000),) at the model's rate. Every window of
        every utterance converts in groups of batch_size (default 1);
        kwargs go to `convert_batch` (pitch_shift, protect)."""
        sr = SAMPLE_RATE
        chunk = int(chunk_seconds * sr)
        pad = int(pad_seconds * sr)
        tgt_per_in = self.rvc.cfg.data.sample_rate / sr

        jobs = []  # (utterance, window, padded window)
        for ui, utt in enumerate(utterances):
            utt = np.asarray(utt, dtype=np.float32)
            up = np.pad(utt, (pad, pad), mode="reflect")
            for ci in range(max(1, int(np.ceil(len(utt) / chunk)))):
                seg = up[ci * chunk: ci * chunk + chunk + 2 * pad]
                if len(seg) < chunk + 2 * pad:
                    seg = np.pad(seg, (0, chunk + 2 * pad - len(seg)))
                jobs.append((ui, ci, seg))

        group_n = max(1, batch_size or 1)
        sid_arr = np.asarray(sids if sids is not None else np.zeros(len(utterances), np.int64))
        handles = []
        for start in range(0, len(jobs), group_n):
            group = jobs[start: start + group_n]
            group = group + [group[-1]] * (group_n - len(group))
            batch = np.stack([g[2] for g in group])
            ids = np.asarray([sid_arr[g[0]] for g in group], np.int64)
            handles.append((start, self.convert_batch(batch, ids, defer=True, **kwargs)))
        outs = {}
        for start, h in handles:
            for g, c in zip(jobs[start: start + group_n], h.cpu().numpy()):
                outs[(g[0], g[1])] = c

        pad_tgt = int(pad * tgt_per_in)
        chunk_tgt = int(chunk * tgt_per_in)
        results = []
        for ui, utt in enumerate(utterances):
            n_chunks = max(1, int(np.ceil(len(utt) / chunk)))
            pieces = [outs[(ui, ci)][pad_tgt: pad_tgt + chunk_tgt] for ci in range(n_chunks)]
            results.append(np.concatenate(pieces)[: int(len(utt) * tgt_per_in)])
        return results
