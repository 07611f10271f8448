"""K4: fused log-mel (wrapper of `csrc/melspec.cu`).

Replaces `rvc_tpu/ops/pallas/melspec.py : pallas_log_mel`. For a CPU
tensor it runs the plain version, `log_mel_reference`
(`ops.stft.log_mel_spectrogram`); for a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from rvc_tpu_torch.ops.kernels import LAUNCHES, build, recorded
from rvc_tpu_torch.ops.stft import log_mel_spectrogram, mel_filterbank


def dft_bases(n_fft: int) -> tuple:
    """Hann-windowed cos and sin DFT bases, each (n_fft, n_fft//2 + 1) f32."""
    n_bins = n_fft // 2 + 1
    t = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = 2.0 * np.pi * ((t * k) % n_fft) / n_fft
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)
    return ((win[:, None] * np.cos(ang)).astype(np.float32),
            (win[:, None] * np.sin(ang)).astype(np.float32))


@lru_cache(maxsize=8)
def _constants(n_fft: int, n_mels: int, sample_rate: int, fmin: float,
               fmax: float, htk: bool, device: str):
    cosb, sinb = dft_bases(n_fft)
    fb_t = np.ascontiguousarray(
        mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax, htk=htk).T)
    return tuple(torch.from_numpy(a).to(device) for a in (cosb, sinb, fb_t))


def _lib():
    lib = build.load("melspec")
    fn = lib.rvc_log_mel
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def log_mel_reference(audio: torch.Tensor, n_fft: int = 1024, hop: int = 160,
                      n_mels: int = 128, sample_rate: int = 16000, fmin: float = 30.0,
                      fmax: float = 8000.0, htk: bool = True,
                      clamp: float = 1e-5) -> torch.Tensor:
    """Plain version of K4, with `log_mel`'s signature."""
    return log_mel_spectrogram(audio, n_fft, n_mels, sample_rate, hop, n_fft,
                               fmin=fmin, fmax=fmax, htk=htk, clamp=clamp)


@recorded
def log_mel(audio: torch.Tensor, n_fft: int = 1024, hop: int = 160,
            n_mels: int = 128, sample_rate: int = 16000, fmin: float = 30.0,
            fmax: float = 8000.0, htk: bool = True,
            clamp: float = 1e-5) -> torch.Tensor:
    """(B, T) float32 audio -> (B, 1 + T // hop, n_mels) log-mel, center=True."""
    if audio.device.type == "cpu":
        return log_mel_reference(audio, n_fft, hop, n_mels, sample_rate, fmin, fmax,
                                 htk, clamp)
    if audio.device.type != "cuda":
        raise ValueError(f"log_mel: unsupported device {audio.device}")
    if audio.dtype != torch.float32 or audio.dim() != 2:
        raise ValueError(f"log_mel: want (B, T) float32, got {tuple(audio.shape)} "
                         f"{audio.dtype}")
    B, T = audio.shape
    if n_fft % 32 or T <= n_fft // 2:
        raise ValueError(f"log_mel: need n_fft % 32 == 0 and T > n_fft/2 "
                         f"(n_fft={n_fft}, T={T})")
    audio = audio.contiguous()
    cosb, sinb, fb_t = _constants(n_fft, n_mels, sample_rate, float(fmin),
                                  float(fmax), bool(htk), str(audio.device))
    n_bins = n_fft // 2 + 1
    n_frames = 1 + T // hop
    mag = torch.empty((B * n_frames, n_bins), device=audio.device)
    out = torch.empty((B, n_frames, n_mels), device=audio.device)
    stream = torch.cuda.current_stream(audio.device).cuda_stream
    err = _lib()(audio.data_ptr(), cosb.data_ptr(), sinb.data_ptr(), fb_t.data_ptr(),
                 mag.data_ptr(), out.data_ptr(), B, T, n_fft, hop, n_bins, n_mels,
                 clamp, stream)
    build.check(err, "log_mel")
    LAUNCHES["log_mel"] += 1
    return out
