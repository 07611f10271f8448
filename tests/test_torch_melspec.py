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
from rvc_tpu_torch.ops.kernels.melspec import dft_bases, log_mel


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
