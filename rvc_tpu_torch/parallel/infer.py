"""Batched and long-form conversion (counterpart of `rvc_tpu/parallel/infer.py`).

`BatchConverter(rvc, mesh)` converts batches of equal-length 16 kHz
utterances, each batch's rows split over the mesh's "data" axis only, as
the reference splits them (`rvc_tpu/parallel/infer.py:54-55`; the models
are whole, so a "model" axis adds no work): one replica of HuBERT, RMVPE
and the synthesizer per data index of the mesh, on its first device
(moved there once, at construction; a device named twice shares one, and
`rvc`'s own device uses `rvc.pipeline`), each shard
run on its device from its own host thread, the outputs concatenated in
row order. Without a mesh, `rvc.pipeline`'s device alone. A replica takes
`rvc.pipeline.source_noise` at every call.
On each device the shard runs the reference's two programs:

    pad T to a multiple of 320 -> f0 program: log-mel [K4] -> RMVPE ->
    decode -> range gate -> semitone shift -> HuBERT -> edge pad to
    (T // 160 + 1) // 2 frames -> f0 cut or padded to 2x that ->
    2x upsample + protect (no retrieval) -> Synthesizer.infer [K3, K1, K2]
    over full lengths

with no high-pass, reflect pad or bucket pad, and no autotune. The pieces
are `Pipeline`'s (`f0`, `_features`, `_synthesize`); the source noise is
one generator seeded 0x5EED per dispatch, as in `Pipeline`, drawn for the
whole batch on each device and cut to its rows (`ops.commons.batch_rows`),
so the output does not depend on the mesh. Audio goes in and comes out
float32. The reference's bf16 / f16 transfer policy is TPU
dispatch machinery and is not ported.

`convert_long_batch` cuts every utterance into windows of chunk + 2 pad
seconds of the reflect-padded utterance, queues every group of
`batch_size` windows (rounded up to a multiple of the data size) on the
cards before it reads any back (the last group padded with repeats of its
last window), then copies the groups to the host in order and reassembles
each utterance from its trimmed windows.
The copies wait behind the whole queue on the one stream; they move 4
bytes a sample at the target rate, which is small beside the groups'
compute, so no side stream overlaps them.
"""

from __future__ import annotations

import contextlib
import copy
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch.nn import functional as F

from rvc_tpu_torch.ops.commons import batch_rows
from rvc_tpu_torch.parallel.mesh import Mesh, indexed_device
from rvc_tpu_torch.pipelines.offline import SAMPLE_RATE, WINDOW, Pipeline, coarse_f0_torch
from rvc_tpu_torch.utils.device import to_device


def _replica(p: Pipeline, device: torch.device) -> Pipeline:
    """The pipeline's networks copied to `device`."""
    def to(m):
        return copy.deepcopy(m).to(device)

    return Pipeline(p.tgt_sr, to(p.synthesizer), to(p.hubert), to(p.rmvpe), p.config,
                    source_noise=p.source_noise)


class BatchConverter:
    """Converts equal-length utterance batches with `rvc`'s models
    (`rvc_tpu_torch.api.RVC`), split over `mesh` (default: the device of
    `rvc.pipeline`)."""

    def __init__(self, rvc, mesh: Optional[Mesh] = None):
        self.rvc = rvc
        self.mesh = mesh or Mesh((rvc.pipeline.device,))
        # one device a data index: the first of its row of the mesh
        self.devices = tuple(indexed_device(d)
                             for d in self.mesh.devices[::self.mesh.shape["model"]])
        self._pipes = {}
        for d in self.devices:
            if d not in self._pipes:
                self._pipes[d] = (rvc.pipeline if d == rvc.pipeline.device
                                  else _replica(rvc.pipeline, d))

    def _shard(self, device: torch.device, audio: np.ndarray, sids: np.ndarray, start: int,
               total: int, pitch_shift: float, protect: float) -> torch.Tensor:
        """Rows start.. of the batch (audio (b, T) padded) on `device`."""
        guard = torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
        with torch.inference_mode(), guard, batch_rows(start, total):
            p = self._pipes[device]
            p.source_noise = self.rvc.pipeline.source_noise     # a replica follows the model
            x = to_device(audio, device)
            sid = to_device(sids, device)
            f0 = p.f0(x, pitch_shift, 0.0)
            p_len0 = x.shape[1] // WINDOW
            feats, _ = p._features(x, p_len0, None, 0.0)
            t_feat = feats.shape[1] * 2
            f0 = f0[:, :t_feat] if p_len0 >= t_feat else F.pad(f0, (0, t_feat - p_len0))
            lengths = torch.full((x.shape[0],), t_feat, dtype=torch.int64, device=device)
            return p._synthesize(feats, feats, lengths, sid, protect, coarse_f0_torch(f0), f0)

    def convert_batch(self, audio_batch: np.ndarray, sids: Optional[np.ndarray] = None,
                      pitch_shift: float = 0.0, protect: float = 0.5, defer: bool = False):
        """Convert one equal-length batch (B, T) of 16 kHz audio -> (B,
        (T padded to 320) * tgt_sr / 16000) float32 at the model's rate; B
        a multiple of the mesh's data size. sids: (B,) speaker ids (0 when
        None). With defer=True the output is returned as a tensor on the
        mesh's first device without waiting for it."""
        B, T = audio_batch.shape
        n = len(self.devices)
        if B % n:
            raise ValueError(f"a batch of {B} rows does not split over {n} devices")
        pad = (-T) % (WINDOW * 2)
        audio_batch = np.asarray(audio_batch, dtype=np.float32)
        if pad:
            audio_batch = np.pad(audio_batch, ((0, 0), (0, pad)))
        sids = np.asarray(sids if sids is not None else np.zeros(B), np.int64)
        b = B // n
        jobs = [(d, audio_batch[i * b:(i + 1) * b], sids[i * b:(i + 1) * b], i * b)
                for i, d in enumerate(self.devices)]
        if n == 1:
            outs = [self._shard(*jobs[0], B, pitch_shift, protect)]
        else:
            with ThreadPoolExecutor(n) as ex:
                futures = [ex.submit(self._shard, *j, B, pitch_shift, protect) for j in jobs]
                outs = [f.result() for f in futures]
        if defer:
            return torch.cat([o.to(self.devices[0]) for o in outs])
        return np.concatenate([o.cpu().numpy() for o in outs])

    def convert_long_batch(self, utterances: Sequence[np.ndarray],
                           sids: Optional[Sequence[int]] = None, chunk_seconds: float = 10.0,
                           pad_seconds: float = 1.0, batch_size: Optional[int] = None,
                           **kwargs) -> List[np.ndarray]:
        """Batched long-form conversion: each utterance (T_i,) at 16 kHz ->
        (int(T_i * tgt_sr / 16000),) at the model's rate. Every window of
        every utterance converts in groups of batch_size (default 1);
        kwargs go to `convert_batch` (pitch_shift, protect). A group holds
        batch_size windows rounded up to a multiple of the data size."""
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

        n_data = len(self.devices)
        group_n = n_data * max(1, -(-(batch_size or n_data) // n_data))
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
