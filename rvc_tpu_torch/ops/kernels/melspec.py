"""K4: fused log-mel (wrapper of `csrc/melspec.cu`).

Replaces `rvc_tpu/ops/pallas/melspec.py : pallas_log_mel`. For a CPU
tensor it runs the plain version, `log_mel_reference`
(`ops.stft.log_mel_spectrogram`); for a CUDA tensor it launches the
kernel or raises.

On the card one call is two launches (`csrc/melspec.cu`): the DFT with
its magnitude, then the mel product with the log. `kernel_constants`
lays out what they read: the windowed bases as (n_fft, bin tile, cos 64 |
sin 64), the filterbank transposed and padded to whole bin tiles, and for
each tile of 32 mels the 32-bin chunks where it has a nonzero weight.
"""

from __future__ import annotations

import ctypes
import functools
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


BIN_TILE = 64     # bins of a DFT block (cos and sin each)
MEL_TILE = 32     # mels of a mel block
MEL_CHUNK = 32    # bins of a mel stage


@lru_cache(maxsize=8)
def kernel_constants(n_fft: int, n_mels: int, sample_rate: int, fmin: float,
                     fmax: float, htk: bool) -> tuple:
    """What the kernel reads, as numpy: the windowed bases (n_fft, n_tiles,
    2 BIN_TILE) f32, cos then sin of each tile's bins, zero past n_bins; the
    filterbank transposed (n_tiles BIN_TILE, n_mels) f32, zero past n_bins;
    and (n_mels / MEL_TILE, 2) int32, the [first, last) MEL_CHUNK chunks of
    bins where each tile of mels has a nonzero weight."""
    n_bins = n_fft // 2 + 1
    n_tiles = -(-n_bins // BIN_TILE)
    cosb, sinb = dft_bases(n_fft)
    pad = ((0, 0), (0, n_tiles * BIN_TILE - n_bins))
    w = np.concatenate([np.pad(cosb, pad).reshape(n_fft, n_tiles, BIN_TILE),
                        np.pad(sinb, pad).reshape(n_fft, n_tiles, BIN_TILE)], axis=-1)
    fb_t = np.pad(mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax, htk=htk).T,
                  ((0, n_tiles * BIN_TILE - n_bins), (0, 0)))
    ranges = []
    for m0 in range(0, n_mels, MEL_TILE):
        nz = np.flatnonzero(fb_t[:, m0:m0 + MEL_TILE].any(axis=1))
        ranges.append((nz[0] // MEL_CHUNK, -(-(nz[-1] + 1) // MEL_CHUNK)) if nz.size else (0, 0))
    return tuple(np.ascontiguousarray(a, dtype=t) for a, t in
                 ((w, np.float32), (fb_t, np.float32), (ranges, np.int32)))


@lru_cache(maxsize=8)
def _device_constants(n_fft: int, n_mels: int, sample_rate: int, fmin: float,
                      fmax: float, htk: bool, device: str):
    return tuple(torch.from_numpy(a).to(device) for a in
                 kernel_constants(n_fft, n_mels, sample_rate, fmin, fmax, htk))


@functools.cache
def _lib():
    """The kernel's C entries, with their ctypes signatures set once."""
    lib = build.load("melspec")
    plan = lib.rvc_log_mel_plan
    plan.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    plan.restype = ctypes.c_int
    run = lib.rvc_log_mel
    run.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                                 ctypes.c_void_p]
    run.restype = ctypes.c_int
    return plan, run


@functools.cache
def launch_plan(B: int, T: int, n_fft: int = 1024, hop: int = 160, n_mels: int = 128) -> dict:
    """The DFT kernel's grid for audio (B, T): blocks, blocks an SM, SMs,
    shared bytes a block and waves over the card's block slots; and the
    mel kernel's blocks."""
    buf = (ctypes.c_int * 5)()
    build.check(_lib()[0](B, T, n_fft, hop, n_mels, buf), "log_mel plan")
    blocks, per_sm, sms, smem, mel_blocks = buf
    return dict(blocks=blocks, blocks_per_sm=per_sm, sms=sms, smem_bytes=smem,
                waves=blocks / (per_sm * sms), mel_blocks=mel_blocks)


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
    if n_fft % 32 or hop % 4 or n_mels % MEL_TILE or T <= n_fft // 2:
        raise ValueError(f"log_mel: need n_fft % 32 == 0, hop % 4 == 0, n_mels % "
                         f"{MEL_TILE} == 0 and T > n_fft/2 (n_fft={n_fft}, hop={hop}, "
                         f"n_mels={n_mels}, T={T})")
    audio = audio.contiguous()
    w, fb_t, ranges = _device_constants(n_fft, n_mels, sample_rate, float(fmin),
                                        float(fmax), bool(htk), str(audio.device))
    n_frames = 1 + T // hop
    mag = torch.empty((B * n_frames, fb_t.shape[0]), device=audio.device)
    out = torch.empty((B, n_frames, n_mels), device=audio.device)
    stream = torch.cuda.current_stream(audio.device).cuda_stream
    err = _lib()[1](audio.data_ptr(), w.data_ptr(), fb_t.data_ptr(), ranges.data_ptr(),
                    mag.data_ptr(), out.data_ptr(), B, T, n_fft, hop, n_mels, clamp, stream)
    build.check(err, "log_mel")
    LAUNCHES["log_mel"] += 1
    return out
