"""Multi-stream realtime pool (counterpart of `rvc_tpu/realtime/pool.py`):
N concurrent voice-change streams batched through ONE block program per
step.

Beyond the reference (one realtime stream per process,
`rvc_mlx/realtime/core.py`): a block is a chain of small launches, so
batching N streams into one (N, L) program converts about one stream's
block latency into N streams' worth of audio. Per-stream state (circular
buffers, SOLA alignment, volume gates) stays on the host; the pitch state
rides on the device as an (N, F) tensor.

All streams share one model; per-stream speaker ids are a vector, and
`pitch_shift`, `protect` and `index_rate` are per call. The pool's gate
differs from the single stream's short-circuit, as in the reference:
every stream is converted, and a gated stream's output is zeroed after
SOLA. Each stream's SOLA step is the single stream's (`sola_crossfade`).

With RVC_TPU_TRACE=1 a step is the span pool/step (its request id the
step's number) over pool/resample_in (to 16 kHz, the circular buffers, the
gate volumes), pool/dispatch (pad, upload, the block program's launches),
pool/readback, pool/resample_out and pool/sola (every stream's).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from rvc_tpu_torch.realtime.core import (
    AUDIO_SAMPLE_RATE,
    SAMPLE_RATE,
    block_geometry,
    build_block_program,
    sola_crossfade,
)
from rvc_tpu_torch.realtime.buffer import circular_write
from rvc_tpu_torch.utils import audio as audio_utils
from rvc_tpu_torch.utils.device import to_device
from rvc_tpu_torch.utils.profiling import trace_span


class VoiceChangerPool:
    """N-stream SOLA voice changer over one batched block program.

    rvc: `rvc_tpu_torch.api.RVC` with an f0 model; the streams convert with
    RMVPE pitch on the fused path."""

    steps = 0       # steps processed: the next step's request id

    def __init__(
        self,
        rvc,
        n_streams: int,
        read_chunk_size: int = 192,
        cross_fade_overlap_size: float = 0.1,
        extra_convert_size: float = 0.5,
        sids: Optional[Sequence[int]] = None,
        silent_threshold: int = 0,
    ):
        self.rvc = rvc
        self.n = int(n_streams)
        self.sids = np.asarray(sids if sids is not None else [0] * self.n, dtype=np.int64)
        if self.sids.shape != (self.n,):
            raise ValueError(f"{self.sids.shape} speaker ids for {self.n} streams")
        self.input_sensitivity = 10 ** (silent_threshold / 20)

        self.block_frame = read_chunk_size * 128
        self.crossfade_frame = int(cross_fade_overlap_size * AUDIO_SAMPLE_RATE)
        self.extra_frame = int(extra_convert_size * AUDIO_SAMPLE_RATE)
        self.sola_search_frame = AUDIO_SAMPLE_RATE // 100

        win = SAMPLE_RATE // 100
        g = block_geometry(self.block_frame, self.extra_frame, self.crossfade_frame,
                           self.sola_search_frame, win)
        self.window_size = win
        self.block_16k = g.block_16k
        self.convert_feature_size = g.convert_feature_size
        self.skip_head = g.skip_head
        self.return_length = g.return_length
        self.silence_front_frames = g.silence_front_frames
        self.convert_buffer = np.zeros((self.n, g.convert_size), np.float32)
        self.audio_buffer = np.zeros((self.n, g.block_16k + g.cross_16k), np.float32)

        fade = np.sin(0.5 * np.pi * np.linspace(
            0, 1, self.crossfade_frame, dtype=np.float32)) ** 2
        self.fade_in, self.fade_out = fade, 1.0 - fade
        self.sola_buffer = np.zeros((self.n, self.crossfade_frame), np.float32)

        pipe = rvc.pipeline
        L = g.convert_size
        self._block_pad = pipe._bucket_samples(L) - L
        self._fns = {}
        self._geom = dict(sf=self.silence_front_frames,
                          bf=g.block_16k // win, F=self.convert_feature_size,
                          skip=self.skip_head, ret=self.return_length,
                          spf=rvc.cfg.data.sample_rate // 100, win=win, L=L)
        self._pitchf_dev = torch.zeros((self.n, self.convert_feature_size),
                                       device=pipe.device)
        self._sids_dev = torch.from_numpy(self.sids).to(pipe.device)

    def _fn(self, use_index: bool):
        if use_index not in self._fns:
            self._fns[use_index] = build_block_program(
                self.rvc.pipeline, use_index=use_index, **self._geom)
        return self._fns[use_index]

    # ------------------------------------------------------------------
    def _convert(self, blocks48: np.ndarray, pitch_shift: float,
                 protect: float, index_rate: float) -> np.ndarray:
        with trace_span("pool/resample_in"):
            a16 = audio_utils.resample(blocks48, AUDIO_SAMPLE_RATE, SAMPLE_RATE)
            for s in range(self.n):
                circular_write(a16[s], self.audio_buffer[s])
                circular_write(a16[s], self.convert_buffer[s])
            self._vols = np.sqrt(np.mean(self.audio_buffer ** 2, axis=1))

        with trace_span("pool/dispatch"):
            use_index = index_rate > 0 and self.rvc.index is not None
            fn = self._fn(use_index)
            buf = self.convert_buffer
            if self._block_pad:
                buf = np.pad(buf, ((0, 0), (0, self._block_pad)), mode="reflect")
            out, self._pitchf_dev = fn(
                to_device(buf, self.rvc.pipeline.device), self._pitchf_dev, self._sids_dev,
                float(protect), float(pitch_shift), 0.0,
                index=self.rvc.index if use_index else None, index_rate=float(index_rate))
        with trace_span("pool/readback"):
            out = out.cpu().numpy()
        with trace_span("pool/resample_out"):
            if self.rvc.cfg.data.sample_rate != AUDIO_SAMPLE_RATE:
                out = audio_utils.resample(out, self.rvc.cfg.data.sample_rate,
                                           AUDIO_SAMPLE_RATE)
        return out

    def process(self, blocks: np.ndarray, pitch_shift: float = 0.0,
                protect: float = 0.5, index_rate: float = 0.0):
        """blocks (N, block_frame) @48 kHz -> (N, block_frame), vols (N,).

        Per-stream SOLA alignment + sin^2 crossfade on the host, exactly
        as the single-stream engine does (`core.sola_crossfade`)."""
        if blocks.shape != (self.n, self.block_frame):
            raise ValueError(f"blocks {blocks.shape}: want {(self.n, self.block_frame)}")
        with trace_span("pool/step", request=self.steps):
            self.steps += 1
            audio = self._convert(blocks, pitch_shift, protect, index_rate)
            outs = np.empty((self.n, self.block_frame), np.float32)
            with trace_span("pool/sola"):
                for s in range(self.n):
                    out = sola_crossfade(audio[s], self.sola_buffer[s], self.fade_in,
                                         self.fade_out, self.block_frame,
                                         self.sola_search_frame)
                    outs[s] = 0.0 if self._vols[s] < self.input_sensitivity else out
        return outs, self._vols
