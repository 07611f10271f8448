"""Multi-period, multi-scale and multi-resolution discriminators
(counterpart of `rvc_tpu/models/discriminators.py`; upstream
`rvc/lib/algorithm/discriminators.py`).

DiscriminatorS (grouped 1-D convs on the waveform), DiscriminatorP per
period (the waveform folded at the period, (k, 1) 2-D convs) and, for
RefineGAN's v3 discriminator, DiscriminatorR per STFT resolution. Plain
weights, as the reference trains them (its MLX trainer folds the weight
norm too); cuDNN in float32. Activations and feature maps take the
reference's channels-last layouts, (B, T, C) and (B, H, W, C), and come
in its order. Module names are the upstream checkpoint keys
(`discriminators.N.convs.M`, `discriminators.N.conv_post`).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from rvc_tpu_torch.models.layers import Conv1d, Conv2d, leaky_relu
from rvc_tpu_torch.ops.stft import stft

PERIODS_V1 = (2, 3, 5, 7, 11, 17)
PERIODS_V2 = (2, 3, 5, 7, 11, 17, 23, 37)
PERIODS_V3 = (2, 3, 5, 7, 11)
# (n_fft, hop, win) of the v3 bank (`rvc/lib/algorithm/discriminators.py:40`)
MRD_RESOLUTIONS = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))

Out = Tuple[torch.Tensor, List[torch.Tensor]]


class DiscriminatorS(nn.Module):
    """Scale discriminator on the raw waveform (B, T, 1)."""

    SPECS = ((1, 16, 15, 1, 7, 1), (16, 64, 41, 4, 20, 4), (64, 256, 41, 4, 20, 16),
             (256, 1024, 41, 4, 20, 64), (1024, 1024, 41, 4, 20, 256),
             (1024, 1024, 5, 1, 2, 1))

    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleList(Conv1d(ci, co, k, stride=s, padding=p, groups=g)
                                   for ci, co, k, s, p, g in self.SPECS)
        self.conv_post = Conv1d(1024, 1, 3, padding=1)

    def forward(self, x: torch.Tensor) -> Out:
        fmap = []
        for conv in self.convs:
            x = leaky_relu(conv(x))
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(x.shape[0], -1), fmap


class DiscriminatorP(nn.Module):
    """Period discriminator: the waveform folded at `period` (a reflect pad
    to a multiple of it), then (k, 1) 2-D convs."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        chans = ((1, 32), (32, 128), (128, 512), (512, 1024), (1024, 1024))
        strides = (stride,) * 4 + (1,)
        pad = ((kernel_size - 1) // 2, 0)
        self.convs = nn.ModuleList(Conv2d(ci, co, (kernel_size, 1), stride=(s, 1), padding=pad)
                                   for (ci, co), s in zip(chans, strides))
        self.conv_post = Conv2d(1024, 1, (3, 1), padding=(1, 0))

    def forward(self, x: torch.Tensor) -> Out:
        B, T, C = x.shape
        p = self.period
        if T % p:
            x = F.pad(x.transpose(1, 2), (0, p - T % p), mode="reflect").transpose(1, 2)
            T = x.shape[1]
        x = x.reshape(B, T // p, p, C)
        fmap = []
        for conv in self.convs:
            x = leaky_relu(conv(x))
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(B, -1), fmap


class DiscriminatorR(nn.Module):
    """Multi-resolution STFT discriminator (used with RefineGAN): the
    rectangular-window magnitude STFT, five 2-D convs over (time, freq)."""

    SPECS = ((1, 32, (3, 9), (1, 1), (1, 4)), (32, 32, (3, 9), (1, 2), (1, 4)),
             (32, 32, (3, 9), (1, 2), (1, 4)), (32, 32, (3, 9), (1, 2), (1, 4)),
             (32, 32, (3, 3), (1, 1), (1, 1)))

    def __init__(self, resolution: Tuple[int, int, int]):
        super().__init__()
        self.resolution = tuple(resolution)
        self.convs = nn.ModuleList(Conv2d(ci, co, k, stride=s, padding=p)
                                   for ci, co, k, s, p in self.SPECS)
        self.conv_post = Conv2d(32, 1, (3, 3), padding=(1, 1))

    def forward(self, x: torch.Tensor) -> Out:
        n_fft, hop, win = self.resolution
        pad = int((n_fft - hop) / 2)
        wav = F.pad(x[:, :, 0][:, None], (pad, pad), mode="reflect")[:, 0]
        mag = stft(wav, n_fft, hop, win, window=torch.ones(win, device=x.device),
                   center=False).abs()
        h = mag[..., None]                                   # (B, T, F, 1)
        fmap = []
        for conv in self.convs:
            h = leaky_relu(conv(h))
            fmap.append(h)
        h = self.conv_post(h)
        fmap.append(h)
        return h.reshape(h.shape[0], -1), fmap


class MultiPeriodDiscriminator(nn.Module):
    """DiscriminatorS, a DiscriminatorP per period and, with
    use_multi_resolution, the DiscriminatorR bank, on (real, generated)."""

    def __init__(self, periods: Sequence[int] = PERIODS_V2,
                 use_multi_resolution: bool = False):
        super().__init__()
        self.periods = tuple(periods)
        self.use_multi_resolution = use_multi_resolution
        discs = [DiscriminatorS()] + [DiscriminatorP(p) for p in self.periods]
        if use_multi_resolution:
            discs += [DiscriminatorR(r) for r in MRD_RESOLUTIONS]
        self.discriminators = nn.ModuleList(discs)

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        """y, y_hat (B, T, 1) -> (y_d_rs, y_d_gs, fmap_rs, fmap_gs)."""
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        for d in self.discriminators:
            dr, fr = d(y)
            dg, fg = d(y_hat)
            y_d_rs.append(dr)
            y_d_gs.append(dg)
            fmap_rs.append(fr)
            fmap_gs.append(fg)
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs


def build_discriminator(cfg) -> MultiPeriodDiscriminator:
    """RefineGAN trains against the v3 discriminator (five periods and the
    multi-resolution bank), every other vocoder against the v2 one
    (`rvc_tpu/train/train_step.py:build_discriminator`)."""
    if cfg.model.vocoder == "RefineGAN":
        return MultiPeriodDiscriminator(PERIODS_V3, use_multi_resolution=True)
    return MultiPeriodDiscriminator()
