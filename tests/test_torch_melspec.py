"""K4's plain version (`log_mel` on a CPU tensor) against the reference's
log-mel, and the kernel's windowed DFT bases against the plain FFT."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_tpu.ops.pallas.melspec import pallas_log_mel
from rvc_tpu.ops.stft import log_mel_spectrogram as jax_log_mel
from rvc_tpu.ops.stft import mel_filterbank as jax_mel_filterbank
from rvc_tpu_torch.ops import stft
from rvc_tpu_torch.ops.kernels import LAUNCHES
from rvc_tpu_torch.ops.kernels.melspec import (BIN_TILE, MEL_CHUNK, MEL_TILE, dft_bases,
                                               kernel_constants, log_mel)


def _audio(T, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 16000
    y = 0.5 * np.sin(2 * np.pi * (120 * t + 200 * t * t)) + 0.05 * rng.standard_normal(T)
    return y.astype(np.float32)[None]


def test_filterbank_is_the_reference_copy():
    np.testing.assert_array_equal(stft.mel_filterbank(16000, 1024, 128, 30, 8000, htk=True),
                                  jax_mel_filterbank(16000, 1024, 128, 30, 8000, htk=True))


@pytest.mark.parametrize("T", [16000, 8000, 12345])
def test_plain_log_mel_matches_reference(T):
    """Both are float32 FFTs (pocketfft in JAX, torch's on the CPU):
    rtol 1e-4, with atol 1e-4 for log values near 0."""
    y = _audio(T)
    ref = np.asarray(jax_log_mel(jnp.asarray(y), 1024, 128, 16000, 160, 1024,
                                 fmin=30, fmax=8000, htk=True))
    before = LAUNCHES["log_mel"]
    got = log_mel(torch.from_numpy(y)).numpy()
    assert LAUNCHES["log_mel"] == before  # a CPU tensor launches nothing
    assert got.shape == ref.shape == (1, 1 + T // 160, 128)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_plain_log_mel_matches_pallas_interpret():
    """The TPU kernel in interpret mode, at the JAX test's own bar
    (tests/unit/test_pallas_mel.py: rtol 1e-3, atol 2e-3)."""
    y = _audio(8000, seed=1)
    ref = np.asarray(pallas_log_mel(jnp.asarray(y), interpret=True))
    got = log_mel(torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=2e-3)


def test_kernel_bases_match_fft():
    """The windowed cos/sin bases the CUDA kernel multiplies by give the
    plain version's magnitude (float64 products; float32 bases: 1e-5)."""
    frames = np.random.default_rng(2).standard_normal((7, 1024))
    cosb, sinb = dft_bases(1024)
    mag = np.hypot(frames @ cosb.astype(np.float64), frames @ sinb.astype(np.float64))
    win = stft.hann_window(1024, torch.float64).numpy()
    ref = np.abs(np.fft.rfft(frames * win, axis=-1))
    np.testing.assert_allclose(mag, ref, rtol=1e-5, atol=1e-5 * ref.max())


FT, SKEW = 64, 4   # csrc/melspec.cu: frames a DFT block, floats inserted every hop


def _emulate_kernel(audio, n_fft=1024, hop=160, n_mels=128):
    """The CUDA kernels' algorithm in plain torch float32: per block of 64
    frames, one span of the reflect-padded audio, skewed by SKEW floats every
    hop samples, frames read as offsets into it; the DFT against the packed
    (n_fft, tile, cos | sin) bases tile by tile, the magnitude; then the mel
    product over each mel tile's chunks only, and the log clamp."""
    w, fb_t, ranges = (torch.from_numpy(a) for a in
                       kernel_constants(n_fft, n_mels, 16000, 30.0, 8000.0, True))
    B, T = audio.shape
    n_frames = 1 + T // hop
    slen = (FT - 1) * hop + n_fft
    k = torch.arange(n_fft)
    offs = k + SKEW * (k // hop)
    i = torch.arange(slen)
    mag = torch.zeros(B, n_frames, fb_t.shape[0])
    for b in range(B):
        for f0 in range(0, n_frames, FT):
            p = f0 * hop + i
            s = (p - n_fft // 2).abs()
            s = torch.where(s >= T, 2 * (T - 1) - s, s)
            x = torch.where(p < T + n_fft, audio[b, s.clamp(0, T - 1)], 0.0)
            span = torch.zeros(slen + SKEW * (slen // hop) + SKEW)
            span[i + SKEW * (i // hop)] = x
            nf = min(FT, n_frames - f0)
            frames = span[torch.arange(nf)[:, None] * (hop + SKEW) + offs[None, :]]
            for nt in range(w.shape[1]):
                re, im = frames @ w[:, nt, :BIN_TILE], frames @ w[:, nt, BIN_TILE:]
                mag[b, f0:f0 + nf, nt * BIN_TILE:(nt + 1) * BIN_TILE] = torch.sqrt(re * re + im * im)
    out = torch.zeros(B, n_frames, n_mels)
    for mt, (c0, c1) in enumerate(ranges.tolist()):
        bins, mels = slice(c0 * MEL_CHUNK, c1 * MEL_CHUNK), slice(mt * MEL_TILE, (mt + 1) * MEL_TILE)
        out[..., mels] = mag[..., bins] @ fb_t[bins, mels]
    return torch.log(torch.clamp(out, min=1e-5))


@pytest.mark.parametrize("B,T", [(1, 8000), (1, 12345), (2, 11000)])
def test_kernel_algorithm_matches_pallas_interpret(B, T):
    """The CUDA kernels' span framing, packed bases and mel chunks, emulated
    in torch, against the TPU kernel in interpret mode at the JAX test's bar
    (rtol 1e-3, atol 2e-3)."""
    y = np.concatenate([_audio(T, seed=3 + b) for b in range(B)])
    ref = np.asarray(pallas_log_mel(jnp.asarray(y), interpret=True))
    got = _emulate_kernel(torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=2e-3)


def test_kernel_constants_layout():
    """The packed bases are the windowed DFT bases tile by tile, zero past
    the last bin; the filterbank is zero past it; each mel tile's chunks
    hold every nonzero weight of its mels."""
    w, fb_t, ranges = kernel_constants(1024, 128, 16000, 30.0, 8000.0, True)
    cosb, sinb = dft_bases(1024)
    n_bins, n_tiles = cosb.shape[1], w.shape[1]
    assert w.shape == (1024, n_tiles, 2 * BIN_TILE) and n_tiles * BIN_TILE >= n_bins
    flat_c = w[:, :, :BIN_TILE].reshape(1024, -1)
    flat_s = w[:, :, BIN_TILE:].reshape(1024, -1)
    np.testing.assert_array_equal(flat_c[:, :n_bins], cosb)
    np.testing.assert_array_equal(flat_s[:, :n_bins], sinb)
    assert not flat_c[:, n_bins:].any() and not flat_s[:, n_bins:].any()
    fb = stft.mel_filterbank(16000, 1024, 128, 30, 8000, htk=True)
    np.testing.assert_array_equal(fb_t[:n_bins], fb.T)
    assert not fb_t[n_bins:].any()
    for mt, (c0, c1) in enumerate(ranges):
        block = fb_t[:, mt * MEL_TILE:(mt + 1) * MEL_TILE]
        kept = np.zeros(len(fb_t), bool)
        kept[c0 * MEL_CHUNK:c1 * MEL_CHUNK] = True
        assert block[~kept].sum() == 0 and block[kept].any()
