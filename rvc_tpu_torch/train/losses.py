"""GAN training losses (counterpart of `rvc_tpu/train/losses.py`;
upstream `rvc/train/losses.py`): LS-GAN discriminator and generator
losses, x2 feature matching, the masked KL with its +-10 clamp on the
log-variances, mel L1 and RefineGAN's multi-scale log10-mel L1.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from rvc_tpu_torch.ops.stft import mel_filterbank, stft


def discriminator_loss(disc_real: Sequence[torch.Tensor],
                       disc_gen: Sequence[torch.Tensor]) -> torch.Tensor:
    """LS-GAN: sum_d mean((1 - D(y))^2) + mean(D(G(z))^2)."""
    loss = 0.0
    for dr, dg in zip(disc_real, disc_gen):
        loss = loss + torch.mean((1.0 - dr) ** 2) + torch.mean(dg ** 2)
    return loss


def generator_loss(disc_gen: Sequence[torch.Tensor]) -> torch.Tensor:
    """LS-GAN: sum_d mean((1 - D(G(z)))^2)."""
    loss = 0.0
    for dg in disc_gen:
        loss = loss + torch.mean((1.0 - dg) ** 2)
    return loss


def feature_loss(fmap_real, fmap_gen) -> torch.Tensor:
    """2 * the sum over every layer of mean |fmap_r - fmap_g|, no gradient
    through the real maps."""
    loss = 0.0
    for dr, dg in zip(fmap_real, fmap_gen):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl.detach() - gl))
    return 2.0 * loss


def kl_loss(z_p: torch.Tensor, logs_q: torch.Tensor, m_p: torch.Tensor,
            logs_p: torch.Tensor, z_mask: torch.Tensor, clamp: float = 10.0,
            denominator: Optional[torch.Tensor] = None) -> torch.Tensor:
    """KL(q || p) per masked element, normalised by the mask's sum (no
    channel factor), with the log-variances clamped to +-clamp.
    `denominator` replaces the mask's sum (a rank's share of the global
    batch's, in data-parallel training)."""
    logs_p = torch.clamp(logs_p, -clamp, clamp)
    logs_q = torch.clamp(logs_q, -clamp, clamp)
    kl = logs_p - logs_q - 0.5 + 0.5 * (z_p - m_p) ** 2 * torch.exp(-2.0 * logs_p)
    if denominator is None:
        denominator = torch.clamp(torch.sum(z_mask), min=1.0)
    return torch.sum(kl * z_mask) / denominator


def mel_l1_loss(mel_real: torch.Tensor, mel_gen: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(mel_real - mel_gen))


def multi_scale_mel_loss(real: torch.Tensor, fake: torch.Tensor, sample_rate: int,
                         n_mels: Sequence[int] = (5, 10, 20, 40, 80, 160, 320),
                         window_lengths: Sequence[int] = (32, 64, 128, 256, 512, 1024, 2048)
                         ) -> torch.Tensor:
    """Multi-scale log10-mel L1 (upstream `rvc/train/mel_processing.py:114-200`),
    on waveforms (B, T): per (n_mels, window), a center STFT at hop window
    // 4, the Slaney mel matrix, log10(clamp 1e-5), L1; summed."""
    loss = 0.0
    for m, win in zip(n_mels, window_lengths):
        fb = torch.from_numpy(mel_filterbank(sample_rate, win, m, 0.0, None, htk=False)
                              ).to(real.device)

        def logmel(w):
            z = stft(w, win, win // 4, win, center=True)
            mag = torch.sqrt(z.real ** 2 + z.imag ** 2 + 1e-6)
            return torch.log10(torch.clamp(mag @ fb.T, min=1e-5))

        loss = loss + torch.mean(torch.abs(logmel(real) - logmel(fake)))
    return loss
