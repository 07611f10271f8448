"""Realtime engine: block conversion + SOLA overlap-add (counterpart of
`rvc_tpu/realtime/core.py`).

A stream arrives in blocks at 48 kHz. Each block is resampled to 16 kHz and
shifted into a fixed circular convert buffer (block + SOLA search + extra
context + crossfade, rounded up to the 10 ms window); the buffer is
converted, `skip_head` frames of context are dropped and `return_length`
frames kept; then `VoiceChanger` aligns the block to the previous one's
tail by SOLA (normalised cross-correlation over a 10 ms search) and
crossfades the two with a sin^2 fade. A block whose volume is below
`silent_threshold`, or that the VAD calls silent, dispatches nothing and
returns zeros.

Two paths, routed as the reference routes them:
- **fused** (RMVPE pitch on an f0 model): one
  block program (`build_block_program`) on the pipeline's device: log-mel
  [K4] of the buffer's tail -> RMVPE -> decode -> range gate -> autotune ->
  semitone shift, the (B, F) pitch state rolled left by one block and its
  tail overwritten, HuBERT on the whole buffer, the IVF search and blend
  when an index is used, coarse pitch, 2x upsample + protect,
  `Synthesizer.infer` [K3, K1, K2] and the skip_head slice. The pitch
  state stays on the device between blocks; the zero roll that silent
  blocks owe it is applied there on the next speech block. One read-back
  a block: the kept samples.
- **staged** (every other pitch method): the tail's f0 through
  `Pipeline.get_f0` into host pitch buffers rolled the same way, then
  `Pipeline.voice_conversion` on the buffer, trimmed on the host.

The fused block program follows the compute dtype of RVC_TPU_BF16, read
at each block (`utils.device.compute_dtype`: bf16 by default on a card),
as the reference's block program: HuBERT on the buffer rounded to bf16,
the retrieval in float32 rounded back, the upsample and enc_p / flow in
bf16 on the pipeline's bf16 copies (`Pipeline.models`), the decoder and
the f0 program float32. The staged path runs float32.

Left out on purpose, as in the rest of the port: the TPU dispatch
machinery of the JAX block program (packed weight buffers and
`unpack_tree`, `_dev_scalar`, `jax.jit`) and its float16 audio upload and
block read-back (`core.py:71, 117, 300`): the port uploads and reads back
float32.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch
from scipy import signal as sp_signal

from rvc_tpu_torch.pipelines.offline import coarse_f0_torch, retrieve
from rvc_tpu_torch.realtime.buffer import circular_write
from rvc_tpu_torch.realtime.vad import VADProcessor
from rvc_tpu_torch.utils import audio as audio_utils
from rvc_tpu_torch.utils.device import compute_dtype, to_device

SAMPLE_RATE = 16000  # internal conversion rate
AUDIO_SAMPLE_RATE = 48000  # client/device rate


def block_geometry(block_frame: int, extra_frame: int, crossfade_frame: int,
                   sola_search_frame: int, window: int = SAMPLE_RATE // 100) -> SimpleNamespace:
    """The 16 kHz buffer geometry of a session whose sizes are given at
    48 kHz (reference `realloc:146`): block_16k and cross_16k samples,
    convert_size (rounded up to the window), F = convert_feature_size
    frames, skip_head, return_length and silence_front_frames."""
    to16 = lambda n: int(n / AUDIO_SAMPLE_RATE * SAMPLE_RATE)
    block_16k = to16(block_frame)
    cross_16k = to16(crossfade_frame)
    sola_16k = to16(sola_search_frame)
    extra_16k = to16(extra_frame)
    convert_size = block_16k + sola_16k + extra_16k + cross_16k
    if (m := convert_size % window) != 0:
        convert_size += window - m
    skip_head = extra_16k // window
    return SimpleNamespace(
        block_16k=block_16k, cross_16k=cross_16k, convert_size=convert_size,
        convert_feature_size=convert_size // window, skip_head=skip_head,
        return_length=convert_size // window - skip_head,
        silence_front_frames=max(skip_head - 5, 0))


def sola_offset_scipy(conv_input: np.ndarray, sola_buffer: np.ndarray) -> int:
    """SOLA by scipy: the argmax of the normalised cross-correlation of the
    previous block's tail over every valid position of conv_input."""
    cor_nom = sp_signal.correlate(conv_input, sola_buffer, mode="valid")
    cor_den = np.sqrt(sp_signal.correlate(conv_input ** 2, np.ones(len(sola_buffer)),
                                          mode="valid") + 1e-8)
    return int(np.argmax(cor_nom / cor_den))


def sola_crossfade(audio: np.ndarray, sola_buffer: np.ndarray, fade_in: np.ndarray,
                   fade_out: np.ndarray, block_size: int, search: int) -> np.ndarray:
    """One stream's SOLA step (`rvc_tpu/realtime/core.py:370-404`): align the
    converted `audio` to the previous block's tail `sola_buffer` over
    `search` samples, crossfade the two with the sin^2 fades, keep the new
    tail in `sola_buffer` (in place) and return block_size samples. Short
    audio is padded with zeros."""
    crossfade = len(sola_buffer)
    min_len = crossfade + search
    if len(audio) < min_len:
        audio = np.pad(audio, (0, min_len - len(audio)))
    audio = audio[sola_offset_scipy(audio[:min_len], sola_buffer):].copy()
    needed = block_size + crossfade
    if len(audio) < needed:
        audio = np.pad(audio, (0, needed - len(audio)))
    audio[:crossfade] = audio[:crossfade] * fade_in + sola_buffer * fade_out
    sola_buffer[:] = audio[block_size:needed]
    return audio[:block_size]


def _pad_right(x: torch.Tensor, n: int) -> torch.Tensor:
    """(B, T) -> (B, T + n), zeros at the end."""
    return torch.nn.functional.pad(x, (0, n))


def build_block_program(pipe, *, sf, bf, F, skip, ret, spf, win, L, use_index=False):
    """The fused realtime block program over `pipe`'s modules (a port
    `Pipeline`), batch-agnostic:

        fn(audio (B, Lp), pitchf (B, F), sid (B,), protect, pitch_shift,
           autotune_strength, index=None, index_rate=0.0)
            -> (block (B, ret * spf), new pitch state (B, F))

    audio is the bucket-padded convert buffer and pitchf the pitch state,
    float32 on the pipeline's device; sid int64 there. With use_index the
    HuBERT features are blended with `index`'s 8 nearest vectors at
    index_rate. Shared by the single-stream `Realtime` and the multi-stream
    pool; nothing goes back to the host inside it."""

    @torch.inference_mode()
    def fn(audio, pitchf_prev, sid, protect, pitch_shift, autotune_strength,
           index=None, index_rate=0.0):
        B = audio.shape[0]
        tail = audio[:, sf * win: L]
        n_tail = tail.shape[1] // win
        # log-mel [K4] -> RMVPE -> decode -> gate -> autotune -> shift
        f0 = pipe.f0(tail, pitch_shift, autotune_strength)
        # roll the pitch state left by one block, overwrite the tail
        new_pitchf = torch.cat([pitchf_prev[:, bf: bf + (F - n_tail)], f0], dim=1)

        dtype = compute_dtype(audio.device)
        feats = pipe.models(dtype)[0](audio.to(dtype), output_hidden_states=True)
        feats_raw = feats
        if use_index:
            feats = retrieve(feats, index, index_rate)
        t_feat = feats.shape[1] * 2
        pf = new_pitchf[:, :t_feat]
        if t_feat > F:
            pf = _pad_right(pf, t_feat - F)
        lengths = torch.full((B,), min(F, t_feat), dtype=torch.int64, device=audio.device)
        wave = pipe._synthesize(feats, feats_raw, lengths, sid, protect,
                                coarse_f0_torch(pf), pf)
        return wave[:, skip * spf: (skip + ret) * spf], new_pitchf

    return fn


class Realtime:
    """Block converter over a fixed circular 16 kHz buffer.

    rvc: `rvc_tpu_torch.api.RVC` (its pipeline, cfg and index)."""

    def __init__(
        self,
        rvc,
        f0_method: str = "rmvpe",
        silent_threshold: int = 0,
        vad_enabled: bool = False,
        vad_sensitivity: int = 3,
        vad_frame_ms: int = 30,
        sid: int = 0,
        post_process: bool = False,
        **fx_kwargs,
    ):
        self.rvc = rvc
        self.sample_rate = SAMPLE_RATE
        self.window_size = SAMPLE_RATE // 100  # 160
        self.f0_method = f0_method
        self.sid = sid
        self.input_sensitivity = 10 ** (silent_threshold / 20)
        self.vad = (VADProcessor(vad_sensitivity, SAMPLE_RATE, vad_frame_ms)
                    if vad_enabled else None)
        self.board = None
        if post_process:
            from rvc_tpu_torch.realtime.fx import build_fx_chain

            self.board = build_fx_chain(**fx_kwargs)
        self.convert_buffer = None
        self.audio_buffer = None
        self.pitch_buffer = None
        self.pitchf_buffer = None

    def realloc(self, block_frame: int, extra_frame: int, crossfade_frame: int,
                sola_search_frame: int) -> None:
        """Frame args are at AUDIO_SAMPLE_RATE (reference `realloc:146`)."""
        g = block_geometry(block_frame, extra_frame, crossfade_frame, sola_search_frame,
                           self.window_size)
        self.convert_feature_size = g.convert_feature_size
        self.skip_head = g.skip_head
        self.return_length = g.return_length
        self.silence_front_frames = g.silence_front_frames

        self.audio_buffer = np.zeros(g.block_16k + g.cross_16k, dtype=np.float32)
        self.convert_buffer = np.zeros(g.convert_size, dtype=np.float32)
        self.pitch_buffer = np.zeros(self.convert_feature_size, dtype=np.int32)
        self.pitchf_buffer = np.zeros(self.convert_feature_size, dtype=np.float32)
        self.block_16k = g.block_16k
        self._block_fns = {}        # fused block programs are shape-bound
        self._pitchf_dev = None
        self._sid_dev = None
        # silent blocks roll the device pitch state lazily: count frames
        # owed and apply the shift on the next speech block
        self._pending_zero_frames = 0

    # ------------------------------------------------------------------
    def _update_pitch(self, pitch_shift: float, f0_autotune: bool,
                      f0_autotune_strength: float) -> None:
        """Recompute f0 only on the non-silent tail, rolling the cached
        buffers (reference `pipeline.py:242-289`)."""
        bf = self.block_16k // self.window_size
        self.pitch_buffer[:-bf] = self.pitch_buffer[bf:]
        self.pitchf_buffer[:-bf] = self.pitchf_buffer[bf:]

        sf = self.silence_front_frames
        audio_tail = self.convert_buffer[sf * self.window_size:]
        n_tail = len(audio_tail) // self.window_size
        pitch, pitchf = self.rvc.pipeline.get_f0(
            audio_tail, n_tail, self.f0_method,
            pitch_shift, f0_autotune, f0_autotune_strength)
        self.pitch_buffer[-n_tail:] = pitch
        self.pitchf_buffer[-n_tail:] = pitchf

    # ------------------------------------------------------------------
    def _fused_block_ok(self) -> bool:
        return self.f0_method == "rmvpe" and self.rvc.pipeline.synthesizer.use_f0

    def _get_block_program(self, use_index: bool = False):
        if use_index in self._block_fns:
            return self._block_fns[use_index]
        pipe = self.rvc.pipeline
        L = len(self.convert_buffer)
        self._block_pad = pipe._bucket_samples(L) - L
        self._block_fns[use_index] = build_block_program(
            pipe, sf=self.silence_front_frames,
            bf=self.block_16k // self.window_size,
            F=self.convert_feature_size, skip=self.skip_head,
            ret=self.return_length, spf=self.rvc.cfg.data.sample_rate // 100,
            win=self.window_size, L=L, use_index=use_index)
        if self._pitchf_dev is None:
            self._pitchf_dev = torch.zeros((1, self.convert_feature_size),
                                           device=pipe.device)
            self._sid_dev = torch.tensor([self.sid], device=pipe.device)
        return self._block_fns[use_index]

    def _apply_pending_roll(self) -> None:
        """Roll the device pitch state by the zero frames the silent blocks
        owe it (all of it once they reach F)."""
        p = self._pending_zero_frames
        if p and self._pitchf_dev is not None:
            st = self._pitchf_dev
            with torch.inference_mode():
                self._pitchf_dev = (torch.zeros_like(st) if p >= st.shape[1]
                                    else _pad_right(st[:, p:], p))
        self._pending_zero_frames = 0

    def inference(
        self,
        audio_input_48k: np.ndarray,
        f0_up_key: float = 0,
        index_rate: float = 0.5,
        protect: float = 0.5,
        volume_envelope: float = 1.0,
        f0_autotune: bool = False,
        f0_autotune_strength: float = 1.0,
    ):
        a16 = audio_utils.resample(audio_input_48k, AUDIO_SAMPLE_RATE, SAMPLE_RATE)
        circular_write(a16, self.audio_buffer)
        circular_write(a16, self.convert_buffer)

        vol = float(np.sqrt(np.mean(self.audio_buffer ** 2)))

        gated = vol < self.input_sensitivity or (
            self.vad is not None and not self.vad.is_speech(a16))

        spf_tgt = self.rvc.cfg.data.sample_rate // 100
        if gated:
            # silence short-circuit (reference `core.py:215-243`): no
            # device dispatch at all. The staged pitch buffers roll with
            # zero f0 now; the fused device pitch state rolls on the next
            # speech block (_pending_zero_frames).
            bf = self.block_16k // self.window_size
            n_frames = self.convert_feature_size
            self.pitch_buffer[:-bf] = self.pitch_buffer[bf:]
            self.pitch_buffer[-bf:] = 1  # coarse bin of f0=0
            self.pitchf_buffer[:-bf] = self.pitchf_buffer[bf:]
            self.pitchf_buffer[-bf:] = 0.0
            self._pending_zero_frames = min(self._pending_zero_frames + bf, n_frames)
            n_out = self.return_length * (AUDIO_SAMPLE_RATE // 100)
            return np.zeros(n_out, dtype=np.float32), vol

        if self._fused_block_ok():
            use_index = index_rate > 0 and self.rvc.index is not None
            fn = self._get_block_program(use_index)
            self._apply_pending_roll()
            buf = self.convert_buffer
            if self._block_pad:
                buf = np.pad(buf, (0, self._block_pad), mode="reflect")
            audio = to_device(buf[None], self.rvc.pipeline.device)
            block, self._pitchf_dev = fn(
                audio, self._pitchf_dev, self._sid_dev, float(protect), float(f0_up_key),
                float(f0_autotune_strength if f0_autotune else 0.0),
                index=self.rvc.index if use_index else None, index_rate=float(index_rate))
            out = block[0].cpu().numpy()
        else:
            self._update_pitch(f0_up_key, f0_autotune, f0_autotune_strength)

            out = self.rvc.pipeline.voice_conversion(
                self.convert_buffer,
                self.pitch_buffer,
                self.pitchf_buffer,
                self.sid,
                self.rvc.index if index_rate > 0 else None,
                index_rate,
                protect,
            )
            # trim skip_head worth of output, keep return_length frames
            out = out[self.skip_head * spf_tgt:
                      (self.skip_head + self.return_length) * spf_tgt]
        if self.rvc.cfg.data.sample_rate != AUDIO_SAMPLE_RATE:
            out = audio_utils.resample(out, self.rvc.cfg.data.sample_rate,
                                       AUDIO_SAMPLE_RATE)
        if self.board is not None:
            out = self.board(out, AUDIO_SAMPLE_RATE)
        return out.astype(np.float32), vol


class VoiceChanger:
    """SOLA streaming wrapper (reference `core.py:300-487`). SOLA runs by
    scipy (`sola_crossfade`), as in the pool."""

    def __init__(
        self,
        rvc,
        read_chunk_size: int = 192,
        cross_fade_overlap_size: float = 0.1,
        extra_convert_size: float = 0.5,
        **kwargs,
    ):
        self.block_frame = read_chunk_size * 128
        self.crossfade_frame = int(cross_fade_overlap_size * AUDIO_SAMPLE_RATE)
        self.extra_frame = int(extra_convert_size * AUDIO_SAMPLE_RATE)
        self.sola_search_frame = AUDIO_SAMPLE_RATE // 100
        self.vc_model = Realtime(rvc, **kwargs)
        self.vc_model.realloc(self.block_frame, self.extra_frame,
                              self.crossfade_frame, self.sola_search_frame)
        fade = np.sin(0.5 * np.pi * np.linspace(0, 1, self.crossfade_frame,
                                                dtype=np.float32)) ** 2
        self.fade_in = fade
        self.fade_out = 1.0 - fade
        self.sola_buffer = np.zeros(self.crossfade_frame, dtype=np.float32)

    def process_audio(self, audio_input: np.ndarray, **kwargs):
        audio, vol = self.vc_model.inference(audio_input, **kwargs)
        out = sola_crossfade(audio, self.sola_buffer, self.fade_in, self.fade_out,
                             audio_input.shape[0], self.sola_search_frame)
        return out, vol

    def on_request(self, audio_input: np.ndarray, **kwargs):
        t0 = time.perf_counter()
        result, vol = self.process_audio(audio_input, **kwargs)
        return result, vol, [0, (time.perf_counter() - t0) * 1000, 0]
