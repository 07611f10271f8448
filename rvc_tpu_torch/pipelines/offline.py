"""Offline voice-conversion pipeline (counterpart of
`rvc_tpu/pipelines/offline.py`, its fused RMVPE path):

    16 kHz mono -> high-pass 48 Hz -> reflect pad -> min-energy chunks ->
    per chunk: bucket pad -> f0 (log-mel [K4] -> RMVPE -> decode -> range
    gate -> autotune -> semitone shift) -> HuBERT -> edge pad -> 2x
    upsample + protect -> Synthesizer.infer [K3, K1, K2] -> trim ->
    concat -> RMS envelope -> peak normalize.

`convert_chunk` is the reference's `fused_convert`: the f0 program
(`_build_f0_program`) and the conversion program (`_build_fused`) run
eagerly on the pipeline's device. Retrieval (`index_rate`), the staged
non-RMVPE path and the TPU dispatch machinery (packing, frozen weights,
f16 transfers, async fetch) are not ported.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from rvc_tpu_torch.configs import PipelineConfig
from rvc_tpu_torch.models.rmvpe import decode_salience
from rvc_tpu_torch.models.synthesizer import SOURCE_NOISE_SEED
from rvc_tpu_torch.ops.kernels.melspec import log_mel
from rvc_tpu_torch.utils import audio as audio_utils

SAMPLE_RATE = 16000
WINDOW = 160
F0_MIN, F0_MAX = 50.0, 1100.0
F0_MEL_MIN = 1127.0 * math.log(1.0 + F0_MIN / 700.0)
F0_MEL_MAX = 1127.0 * math.log(1.0 + F0_MAX / 700.0)

# autotune note table (a copy of `rvc_tpu.pitch.autotune.NOTE_TABLE`)
NOTE_TABLE = np.array([
    49.00, 51.91, 55.00, 58.27, 61.74, 65.41, 69.30, 73.42, 77.78, 82.41,
    87.31, 92.50, 98.00, 103.83, 110.00, 116.54, 123.47, 130.81, 138.59,
    146.83, 155.56, 164.81, 174.61, 185.00, 196.00, 207.65, 220.00, 233.08,
    246.94, 261.63, 277.18, 293.66, 311.13, 329.63, 349.23, 369.99, 392.00,
    415.30, 440.00, 466.16, 493.88, 523.25, 554.37, 587.33, 622.25, 659.25,
    698.46, 739.99, 783.99, 830.61, 880.00, 932.33, 987.77, 1046.50,
], dtype=np.float32)


def coarse_f0(f0: torch.Tensor) -> torch.Tensor:
    """Continuous f0 -> 1..255 coarse mel-quantized bins (int64)."""
    f0_mel = 1127.0 * torch.log(1.0 + f0 / 700.0)
    scaled = torch.where(f0_mel > 0,
                         (f0_mel - F0_MEL_MIN) * 254.0 / (F0_MEL_MAX - F0_MEL_MIN) + 1.0,
                         f0_mel)
    return torch.round(torch.clamp(scaled, 1.0, 255.0)).long()


def autotune_f0(f0: torch.Tensor, strength: float) -> torch.Tensor:
    """Snap voiced f0 toward the nearest table note by `strength` (0 = identity)."""
    table = torch.from_numpy(NOTE_TABLE).to(f0.device)
    closest = table[torch.argmin((f0[..., None] - table).abs(), dim=-1)]
    return torch.where(f0 > 0, f0 + (closest - f0) * strength, f0)


def upsample_protect(feats: torch.Tensor, feats_raw: torch.Tensor, pitchf: torch.Tensor,
                     protect: float, upsample: int = 2) -> torch.Tensor:
    """2x nearest-neighbour time upsample of (B, T, C) features, then the
    unvoiced 'protect' blend toward the pre-retrieval features."""
    f = feats.repeat_interleave(upsample, dim=1)
    if protect >= 0.5:
        return f
    fr = feats_raw.repeat_interleave(upsample, dim=1)
    w = torch.where(pitchf > 0, 1.0, protect)[:, :, None].to(f.dtype)
    return f * w + fr * (1.0 - w)


class Pipeline:
    """Offline conversion over the port's modules, all on one device.

    synthesizer: `models.synthesizer.Synthesizer`; hubert:
    `models.hubert.HubertModel`; rmvpe: `models.rmvpe.E2E`. With
    source_noise the NSF source noise comes from a generator seeded
    0x5EED on the device for each chunk (the reference's fixed key; torch
    draws other numbers); without it the source is noise-free.
    """

    def __init__(self, tgt_sr: int, synthesizer, hubert, rmvpe,
                 config: Optional[PipelineConfig] = None, source_noise: bool = True):
        self.tgt_sr = tgt_sr
        self.config = config or PipelineConfig()
        self.synthesizer = synthesizer
        self.hubert = hubert
        self.rmvpe = rmvpe
        self.source_noise = source_noise
        self.device = next(synthesizer.parameters()).device
        self.window = WINDOW
        self.t_pad = SAMPLE_RATE * self.config.x_pad
        self.t_query = SAMPLE_RATE * self.config.x_query
        self.t_center = SAMPLE_RATE * self.config.x_center
        self.t_max = SAMPLE_RATE * self.config.x_max

    # ------------------------------------------------------------------
    def f0(self, audio: torch.Tensor, pitch_shift: float,
           autotune_strength: float) -> torch.Tensor:
        """The f0 program: padded audio (B, T) -> f0 (B, T // 160)."""
        p_len0 = audio.shape[1] // WINDOW
        mel = log_mel(audio, 1024, WINDOW, 128, SAMPLE_RATE, 30.0, 8000.0, htk=True)
        n_frames = mel.shape[1]
        pad = 32 * ((n_frames - 1) // 32 + 1) - n_frames
        if pad:
            mel = F.pad(mel.transpose(1, 2), (0, pad), mode="reflect").transpose(1, 2)
        hidden = self.rmvpe(mel)[:, :n_frames]
        f0 = decode_salience(hidden, 0.03)[:, :p_len0]
        f0 = torch.where((f0 >= F0_MIN) & (f0 <= F0_MAX), f0, torch.zeros_like(f0))
        f0 = autotune_f0(f0, autotune_strength)
        return f0 * 2.0 ** (pitch_shift / 12.0)

    def _convert(self, audio: torch.Tensor, f0: torch.Tensor, sid: int, p_len: int,
                 protect: float) -> torch.Tensor:
        """The conversion program: padded audio (1, T) and its f0 -> wave
        (1, samples) at the target rate, before the trim."""
        p_len0 = audio.shape[1] // WINDOW
        feats = self.hubert(audio, output_hidden_states=True)
        # edge-replicate so the x2 feature grid covers every 10 ms frame
        hub_pad = (p_len0 + 1) // 2 - feats.shape[1]
        if hub_pad > 0:
            feats = F.pad(feats.transpose(1, 2), (0, hub_pad), mode="replicate").transpose(1, 2)
        t_feat = feats.shape[1] * 2
        f0 = f0[:, :t_feat] if p_len0 >= t_feat else F.pad(f0, (0, t_feat - p_len0))
        # zero f0 beyond the true (unpadded) frame count
        frame_valid = torch.arange(t_feat, device=f0.device)[None, :] < p_len
        f0 = torch.where(frame_valid, f0, torch.zeros_like(f0))
        feats_up = upsample_protect(feats, feats, f0, protect)
        generator = None
        if self.source_noise:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(SOURCE_NOISE_SEED)
        lengths = torch.tensor([p_len], device=self.device)
        sid_t = torch.tensor([sid], device=self.device)
        wave, _ = self.synthesizer.infer(feats_up, lengths, coarse_f0(f0), f0, sid_t,
                                         generator=generator)
        return wave[:, :, 0]

    @torch.inference_mode()
    def convert_chunk(self, audio0: np.ndarray, sid: int, pitch_shift: float,
                      autotune_strength: float, protect: float,
                      trim_frames: int = 0) -> np.ndarray:
        """One padded 16 kHz chunk -> its waveform at the target rate, with
        trim_frames 10 ms frames of context dropped from each end."""
        n = len(audio0)
        n_pad = self._bucket_samples(n)
        padded = np.pad(audio0.astype(np.float32), (0, n_pad - n),
                        mode="reflect" if n_pad - n < n else "constant")
        audio = torch.from_numpy(padded)[None].to(self.device)
        p_len = n // self.window
        f0 = self.f0(audio, pitch_shift, autotune_strength)
        wave = self._convert(audio, f0, sid, p_len, protect)
        spf = self.tgt_sr // 100
        wave = wave[:, trim_frames * spf: wave.shape[1] - trim_frames * spf]
        out = wave[0].float().cpu().numpy()
        return out[: max(p_len - 2 * trim_frames, 0) * spf]

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
                 volume_envelope: float = 1.0, protect: float = 0.5,
                 f0_autotune: bool = False,
                 f0_autotune_strength: float = 1.0) -> np.ndarray:
        """Full conversion: 16 kHz mono float -> target-rate waveform."""
        audio = audio_utils.highpass_filter(np.asarray(audio, dtype=np.float32),
                                            SAMPLE_RATE, 48.0, 5)
        t_pad = self.t_pad
        audio_pad = np.pad(audio, (t_pad, t_pad), mode="reflect")
        strength = f0_autotune_strength if f0_autotune else 0.0
        out = np.concatenate([
            self.convert_chunk(audio_pad[s: e + 2 * t_pad], sid, pitch_shift, strength,
                               protect, trim_frames=t_pad // self.window)
            for s, e in self.chunk_bounds(audio)])
        if volume_envelope != 1:
            out = audio_utils.change_rms(audio, SAMPLE_RATE, out, self.tgt_sr,
                                         volume_envelope)
        return audio_utils.peak_normalize(out, 0.99)
