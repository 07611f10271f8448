"""Offline voice-conversion pipeline (counterpart of
`rvc_tpu/pipelines/offline.py`):

    16 kHz mono -> high-pass 48 Hz -> reflect pad -> min-energy chunks ->
    per chunk: bucket pad -> f0 -> HuBERT -> IVF retrieval blend
    (index_rate > 0) -> edge pad -> 2x upsample + protect ->
    Synthesizer.infer [K3, K1, K2] -> trim -> concat -> RMS envelope ->
    peak normalize.

Two paths, routed as the reference routes them. `convert_chunk` is the
reference's `fused_convert`, for RMVPE pitch with no `input_f0` and no
`proposed_pitch`: the f0 program (log-mel [K4] -> RMVPE -> decode -> range
gate -> autotune -> semitone shift) and the conversion program run eagerly
on the pipeline's device. Every other chunk takes the staged path:
`get_f0` on the host (the `PitchExtractor` of `f0_method` on the unpadded
chunk, or the user's `input_f0`; then autotune or `proposed_pitch`, the
semitone shift and the coarse bins in numpy), then `voice_conversion`,
trimmed on the host; f0-less models take it without pitch. The TPU
dispatch machinery (packing, frozen weights, f16 transfers, async fetch,
chunk batching) is not ported.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from rvc_tpu_torch.configs import PipelineConfig
from rvc_tpu_torch.models.rmvpe import RMVPE, decode_salience
from rvc_tpu_torch.models.synthesizer import SOURCE_NOISE_SEED
from rvc_tpu_torch.pitch import PitchExtractor, autotune_f0
from rvc_tpu_torch.pitch.autotune import NOTE_TABLE
from rvc_tpu_torch.retrieval.ivf import IVFFlatIndex, index_blend
from rvc_tpu_torch.utils import audio as audio_utils

SAMPLE_RATE = 16000
WINDOW = 160
F0_MIN, F0_MAX = 50.0, 1100.0
F0_MEL_MIN = 1127.0 * math.log(1.0 + F0_MIN / 700.0)
F0_MEL_MAX = 1127.0 * math.log(1.0 + F0_MAX / 700.0)

def coarse_f0(f0: np.ndarray) -> np.ndarray:
    """Continuous f0 -> 1..255 coarse mel-quantized bins (int32, host)."""
    f0_mel = 1127.0 * np.log(1.0 + f0 / 700.0)
    scaled = np.where(f0_mel > 0,
                      (f0_mel - F0_MEL_MIN) * 254.0 / (F0_MEL_MAX - F0_MEL_MIN) + 1.0, f0_mel)
    return np.rint(np.clip(scaled, 1.0, 255.0)).astype(np.int32)


def coarse_f0_torch(f0: torch.Tensor) -> torch.Tensor:
    """`coarse_f0` on the device, for the fused path (int64)."""
    f0_mel = 1127.0 * torch.log(1.0 + f0 / 700.0)
    scaled = torch.where(f0_mel > 0,
                         (f0_mel - F0_MEL_MIN) * 254.0 / (F0_MEL_MAX - F0_MEL_MIN) + 1.0,
                         f0_mel)
    return torch.round(torch.clamp(scaled, 1.0, 255.0)).long()


def autotune_f0_torch(f0: torch.Tensor, strength: float) -> torch.Tensor:
    """Snap voiced f0 toward the nearest table note by `strength` (0 =
    identity) on the device, for the fused path."""
    table = torch.from_numpy(NOTE_TABLE).to(f0.device)
    closest = table[torch.argmin((f0[..., None] - table).abs(), dim=-1)]
    return torch.where(f0 > 0, f0 + (closest - f0) * strength, f0)


def upsample_protect(feats: torch.Tensor, feats_raw: torch.Tensor,
                     pitchf: Optional[torch.Tensor], protect: float,
                     upsample: int = 2) -> torch.Tensor:
    """2x nearest-neighbour time upsample of (B, T, C) features, then the
    unvoiced 'protect' blend toward the pre-retrieval features (only for
    protect < 0.5; pitchf is not read otherwise)."""
    f = feats.repeat_interleave(upsample, dim=1)
    if protect >= 0.5:
        return f
    fr = feats_raw.repeat_interleave(upsample, dim=1)
    w = torch.where(pitchf > 0, 1.0, protect)[:, :, None].to(f.dtype)
    return f * w + fr * (1.0 - w)


def _edge_pad(feats: torch.Tensor, n: int) -> torch.Tensor:
    """Repeat the last frame of (B, T, C) n more times."""
    return F.pad(feats.transpose(1, 2), (0, n), mode="replicate").transpose(1, 2)


def retrieve(feats: torch.Tensor, index: IVFFlatIndex, index_rate: float) -> torch.Tensor:
    """The retrieval blend of (B, T, C) HuBERT features: every frame's 8
    nearest index vectors at the index's nprobe, blended in at index_rate."""
    B, T, C = feats.shape
    q = feats.reshape(B * T, C)
    d, i = index.search_device(q, 8)
    return index_blend(q, index.tensors(q.device)[0][i], d, index_rate).reshape(B, T, C)


class Pipeline:
    """Offline conversion over the port's modules, all on one device.

    synthesizer: `models.synthesizer.Synthesizer`; hubert:
    `models.hubert.HubertModel`; rmvpe: `models.rmvpe.E2E`, which RMVPE
    pitch takes on both paths. pitch_extractor: the staged path's
    `PitchExtractor`, made anew (on the pipeline's device) when a chunk
    asks for another method or CREPE hop. With source_noise the NSF source
    noise comes from a generator seeded 0x5EED on the device for each chunk
    (the reference's fixed key; torch draws other numbers); without it the
    source is noise-free.
    """

    def __init__(self, tgt_sr: int, synthesizer, hubert, rmvpe,
                 config: Optional[PipelineConfig] = None, source_noise: bool = True,
                 pitch_extractor: Optional[PitchExtractor] = None):
        self.tgt_sr = tgt_sr
        self.config = config or PipelineConfig()
        self.synthesizer = synthesizer
        self.hubert = hubert
        self.rmvpe = rmvpe
        self.source_noise = source_noise
        self.device = next(synthesizer.parameters()).device
        self.pitch_extractor = pitch_extractor
        self.window = WINDOW
        self.t_pad = SAMPLE_RATE * self.config.x_pad
        self.t_query = SAMPLE_RATE * self.config.x_query
        self.t_center = SAMPLE_RATE * self.config.x_center
        self.t_max = SAMPLE_RATE * self.config.x_max

    # ------------------------------------------------------------------
    def f0(self, audio: torch.Tensor, pitch_shift: float,
           autotune_strength: float) -> torch.Tensor:
        """The f0 program: padded audio (B, T) -> f0 (B, T // 160)."""
        rmvpe = RMVPE(self.rmvpe)
        hidden = rmvpe.mel2hidden(rmvpe.mel(audio))
        f0 = decode_salience(hidden, 0.03)[:, :audio.shape[1] // WINDOW]
        f0 = torch.where((f0 >= F0_MIN) & (f0 <= F0_MAX), f0, torch.zeros_like(f0))
        f0 = autotune_f0_torch(f0, autotune_strength)
        return f0 * 2.0 ** (pitch_shift / 12.0)

    def get_f0(self, x: np.ndarray, p_len: int, f0_method: str = "rmvpe",
               pitch_shift: float = 0.0, f0_autotune: bool = False,
               f0_autotune_strength: float = 1.0, input_f0: Optional[np.ndarray] = None,
               proposed_pitch: bool = False, proposed_pitch_threshold: float = 155.0,
               f0_hop_length: int = 160) -> Tuple[np.ndarray, np.ndarray]:
        """The staged path's f0, on the host: x (T,) 16 kHz -> (coarse
        (p_len,) int32, continuous (p_len,) float32). input_f0 is taken as
        given (no range gate); proposed_pitch shifts by whole semitones, at
        most 12, toward proposed_pitch_threshold Hz."""
        if input_f0 is not None:
            f0 = np.asarray(input_f0, dtype=np.float32)
        else:
            if (self.pitch_extractor is None or self.pitch_extractor.method != f0_method
                    or self.pitch_extractor.crepe_hop != f0_hop_length):
                self.pitch_extractor = PitchExtractor(f0_method, crepe_hop=f0_hop_length,
                                                      device=self.device,
                                                      rmvpe=RMVPE(self.rmvpe))
            f0 = self.pitch_extractor.extract(x, F0_MIN, F0_MAX)
        if f0_autotune:
            f0 = autotune_f0(f0, f0_autotune_strength)
        elif proposed_pitch:
            # the median of the voiced f0, interpolated over unvoiced frames
            valid = np.where(f0 > 0)[0]
            up_key = 0
            if len(valid) >= 2:
                median_f0 = float(np.median(np.interp(np.arange(len(f0)), valid, f0[valid])))
                if median_f0 > 0 and not np.isnan(median_f0):
                    up_key = int(np.clip(
                        np.round(12 * np.log2(proposed_pitch_threshold / median_f0)), -12, 12))
            pitch_shift = pitch_shift + up_key
        f0 = f0 * (2.0 ** (pitch_shift / 12.0))
        if len(f0) < p_len:
            f0 = np.pad(f0, (0, p_len - len(f0)))
        f0 = f0[:p_len]
        return coarse_f0(f0), f0.astype(np.float32)

    def _features(self, audio: torch.Tensor, n_frames: int, index: Optional[IVFFlatIndex],
                  index_rate: float) -> Tuple[torch.Tensor, torch.Tensor]:
        """HuBERT features of padded audio (1, T), then the retrieval blend
        when an index is given at index_rate > 0, both edge-padded so the x2
        grid covers n_frames 10 ms frames: (feats, feats before retrieval)."""
        feats = self.hubert(audio, output_hidden_states=True)
        feats_raw = feats
        if index is not None and index_rate > 0:
            feats = retrieve(feats, index, index_rate)
        hub_pad = (n_frames + 1) // 2 - feats.shape[1]
        if hub_pad > 0:
            feats, feats_raw = _edge_pad(feats, hub_pad), _edge_pad(feats_raw, hub_pad)
        return feats, feats_raw

    def _synthesize(self, feats: torch.Tensor, feats_raw: torch.Tensor, p_len: int, sid: int,
                    protect: float, pitch: Optional[torch.Tensor] = None,
                    pitchf: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Features (1, T, C) and pitch (coarse, f0; (1, 2T) each, or None
        for an f0-less model) -> wave (1, samples) at the target rate."""
        feats_up = upsample_protect(feats, feats_raw, pitchf,
                                    protect if pitchf is not None else 1.0)
        generator = None
        if self.source_noise and pitchf is not None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(SOURCE_NOISE_SEED)
        wave, _ = self.synthesizer.infer(feats_up, torch.tensor([p_len], device=self.device),
                                         pitch, pitchf, torch.tensor([sid], device=self.device),
                                         generator=generator)
        return wave[:, :, 0]

    def _convert(self, audio: torch.Tensor, f0: torch.Tensor, sid: int, p_len: int,
                 protect: float, index: Optional[IVFFlatIndex] = None,
                 index_rate: float = 0.0) -> torch.Tensor:
        """The conversion program: padded audio (1, T) and its f0 -> wave
        (1, samples) at the target rate, before the trim."""
        p_len0 = audio.shape[1] // WINDOW
        feats, feats_raw = self._features(audio, p_len0, index, index_rate)
        t_feat = feats.shape[1] * 2
        f0 = f0[:, :t_feat] if p_len0 >= t_feat else F.pad(f0, (0, t_feat - p_len0))
        # zero f0 beyond the true (unpadded) frame count
        frame_valid = torch.arange(t_feat, device=f0.device)[None, :] < p_len
        f0 = torch.where(frame_valid, f0, torch.zeros_like(f0))
        return self._synthesize(feats, feats_raw, p_len, sid, protect, coarse_f0_torch(f0), f0)

    def _upload(self, audio0: np.ndarray) -> torch.Tensor:
        """A chunk bucket-padded as the reference pads it, on the device (1, T)."""
        n = len(audio0)
        n_pad = self._bucket_samples(n)
        padded = np.pad(audio0.astype(np.float32), (0, n_pad - n),
                        mode="reflect" if n_pad - n < n else "constant")
        return torch.from_numpy(padded)[None].to(self.device)

    @torch.inference_mode()
    def convert_chunk(self, audio0: np.ndarray, sid: int, pitch_shift: float,
                      autotune_strength: float, protect: float,
                      trim_frames: int = 0, index: Optional[IVFFlatIndex] = None,
                      index_rate: float = 0.0) -> np.ndarray:
        """One padded 16 kHz chunk -> its waveform at the target rate, with
        trim_frames 10 ms frames of context dropped from each end."""
        audio = self._upload(audio0)
        p_len = len(audio0) // self.window
        f0 = self.f0(audio, pitch_shift, autotune_strength)
        wave = self._convert(audio, f0, sid, p_len, protect, index, index_rate)
        spf = self.tgt_sr // 100
        wave = wave[:, trim_frames * spf: wave.shape[1] - trim_frames * spf]
        out = wave[0].float().cpu().numpy()
        return out[: max(p_len - 2 * trim_frames, 0) * spf]

    @torch.inference_mode()
    def voice_conversion(self, audio0: np.ndarray, pitch: Optional[np.ndarray],
                         pitchf: Optional[np.ndarray], sid: int,
                         index: Optional[IVFFlatIndex], index_rate: float,
                         protect: float = 0.5) -> np.ndarray:
        """The staged path: one padded 16 kHz chunk and its host pitch
        (coarse and continuous, (p_len,) each; None for an f0-less model)
        -> its waveform at the target rate, p_len frames long, context
        untrimmed."""
        audio = self._upload(audio0)
        p_len = len(audio0) // self.window
        feats, feats_raw = self._features(audio, p_len, index, index_rate)
        pitch_t = pitchf_t = None
        if pitch is not None and pitchf is not None:
            t_feat = feats.shape[1] * 2
            pitch_arr = np.zeros(t_feat, dtype=np.int32)
            pitchf_arr = np.zeros(t_feat, dtype=np.float32)
            pitch_arr[: min(p_len, len(pitch))] = pitch[:p_len]
            pitchf_arr[: min(p_len, len(pitchf))] = pitchf[:p_len]
            pitch_t = torch.from_numpy(pitch_arr).long()[None].to(self.device)
            pitchf_t = torch.from_numpy(pitchf_arr)[None].to(self.device)
        wave = self._synthesize(feats, feats_raw, p_len, sid, protect, pitch_t, pitchf_t)
        return wave[0].float().cpu().numpy()[: p_len * (self.tgt_sr // 100)]

    # ------------------------------------------------------------------
    def _bucket_samples(self, n: int) -> int:
        b = self.config.frame_bucket * self.window
        return ((n + b - 1) // b) * b

    def _find_split_points(self, audio: np.ndarray) -> List[int]:
        """Minimum-|moving-average| split points every ~x_center seconds."""
        if len(audio) <= self.t_max:
            return []
        smooth = np.convolve(np.abs(audio), np.ones(self.window) / self.window, mode="same")
        pts = []
        for center in range(self.t_center, len(audio), self.t_center):
            lo = max(center - self.t_query, 0)
            hi = min(center + self.t_query, len(audio))
            pts.append(lo + int(np.argmin(smooth[lo:hi])))
        return pts

    def chunk_bounds(self, audio: np.ndarray) -> List[Tuple[int, int]]:
        """(start, end) sample bounds of the chunks the pipeline converts."""
        bounds, prev = [], 0
        for t in self._find_split_points(audio):
            t = (t // self.window) * self.window
            bounds.append((prev, t))
            prev = t
        bounds.append((prev, len(audio)))
        return bounds

    def pipeline(self, audio: np.ndarray, sid: int = 0, pitch_shift: float = 0.0,
                 f0_method: str = "rmvpe", index: Optional[IVFFlatIndex] = None,
                 index_rate: float = 0.75, pitch_guidance: bool = True,
                 volume_envelope: float = 1.0, protect: float = 0.5,
                 f0_autotune: bool = False, f0_autotune_strength: float = 1.0,
                 input_f0: Optional[np.ndarray] = None, proposed_pitch: bool = False,
                 proposed_pitch_threshold: float = 155.0,
                 f0_hop_length: int = 160) -> np.ndarray:
        """Full conversion: 16 kHz mono float -> target-rate waveform.

        Retrieval runs when an index is given and index_rate > 0. With
        RMVPE pitch, no input_f0 and no proposed_pitch, an f0 model's chunks
        take the fused path, trimmed on the device; other pitch methods
        (`PitchExtractor.METHODS`, hybrid[a+b+...]), a user's input_f0 (one
        value per 10 ms frame of `audio`) and proposed_pitch take the staged
        path, as does an f0-less model (without pitch), trimmed on the
        host. An f0 model without pitch guidance raises (its NSF decoder
        needs an f0).
        """
        use_f0 = self.synthesizer.use_f0
        if use_f0 and not pitch_guidance:
            raise ValueError("pitch_guidance=False needs an f0-less model: an f0 model's "
                             "NSF decoder needs pitch")
        audio = audio_utils.highpass_filter(np.asarray(audio, dtype=np.float32),
                                            SAMPLE_RATE, 48.0, 5)
        t_pad = self.t_pad
        audio_pad = np.pad(audio, (t_pad, t_pad), mode="reflect")
        # the user's f0 curve, padded once to the padded audio's frame grid so
        # each chunk slices its own window
        input_f0_pad = None
        if input_f0 is not None:
            pw = t_pad // self.window
            input_f0_pad = np.pad(np.asarray(input_f0, dtype=np.float32), (pw, pw),
                                  mode="edge")
        fused = use_f0 and f0_method == "rmvpe" and input_f0 is None and not proposed_pitch
        pad_tgt = int(t_pad * (self.tgt_sr / SAMPLE_RATE))
        out_chunks = []
        for s, e in self.chunk_bounds(audio):
            chunk = audio_pad[s: e + 2 * t_pad]
            if fused:
                out_chunks.append(self.convert_chunk(
                    chunk, sid, pitch_shift, f0_autotune_strength if f0_autotune else 0.0,
                    protect, trim_frames=t_pad // self.window, index=index,
                    index_rate=index_rate))
                continue
            pitch = pitchf = None
            if use_f0:
                chunk_f0 = None
                if input_f0_pad is not None:
                    chunk_f0 = input_f0_pad[s // self.window: (e + 2 * t_pad) // self.window]
                pitch, pitchf = self.get_f0(
                    chunk, len(chunk) // self.window, f0_method, pitch_shift, f0_autotune,
                    f0_autotune_strength, chunk_f0, proposed_pitch, proposed_pitch_threshold,
                    f0_hop_length)
            conv = self.voice_conversion(chunk, pitch, pitchf, sid, index, index_rate, protect)
            out_chunks.append(conv[pad_tgt:-pad_tgt] if pad_tgt else conv)
        out = np.concatenate(out_chunks)
        if volume_envelope != 1:
            out = audio_utils.change_rms(audio, SAMPLE_RATE, out, self.tgt_sr,
                                         volume_envelope)
        return audio_utils.peak_normalize(out, 0.99)
