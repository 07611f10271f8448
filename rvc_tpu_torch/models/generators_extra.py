"""MRF HiFi-GAN and RefineGAN vocoders (counterpart of
`rvc_tpu/models/generators_extra.py`; upstream
`rvc/lib/algorithm/generators/hifigan_mrf.py` and `refinegan.py`).

Plain PyTorch in float32: the reference writes neither decoder as a Pallas
kernel, and neither reaches the ResBlock kernels K1/K2. Module names are
the upstream checkpoint keys (`dec.upsamples.N`, `dec.mrfs.I.J.layers.K`,
`dec.m_source.l_linear`; `dec.pre_conv`, `dec.downsample_blocks.N`,
`dec.upsample_conv_blocks.N.blocks.J.{0,1,2}`, `dec.m_source.merge.0`).

Noise (the harmonics' initial phases, the source noise, AdaIN's noise) is
drawn from an explicit `torch.Generator`, in a fixed order; with none it is
zero, as the reference's `rng=None`. Torch cannot draw the reference's JAX
random bits, so outputs with noise agree with it only in their statistics.
RefineGAN's order: the sine template's initial phases (B, 1) and noise
(B, T*upp, 1), then for each stage and each branch AdaIN before and AdaIN
after, each at its input's (B, T, C).

With RVC_TPU_TRACE=1 RefineGAN opens the spans decoder/source (the sine
template, its merge, `pre_conv` and the decimation path) and decoder/stage
around each upsampling stage (`refine_stage`: the linear resize and the
ParallelResBlock, a module function so that a caller can wrap it).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from rvc_tpu_torch.models.layers import Conv1d, ConvTranspose1d, init_normal, leaky_relu
from rvc_tpu_torch.ops.commons import draw
from rvc_tpu_torch.utils.profiling import trace_span


def audio_rate_sines(f0: torch.Tensor, sample_rate: int, harmonic_num: int = 0,
                     sine_amp: float = 0.1, noise_std: float = 0.003,
                     voiced_threshold: float = 0.0,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Per-sample sine bank with harmonics (`hifigan_mrf.py:128-175`):
    f0 at audio rate (B, T, 1) -> (B, T, harmonic_num + 1), float32.

    The reference's formula, step for step: phase = 2 pi cumsum((f0 k / sr)
    mod 1 + wrap), where wrap is -1 at each sample where the cumsum's
    fractional part wraps, so the accumulated phase stays within one turn;
    a random initial phase for harmonics > 0; voiced gating and a noise
    floor. An integer error in the wrap count leaves the sines unchanged.
    """
    B, T, _ = f0.shape
    f0 = f0.float()
    dims = harmonic_num + 1
    mult = torch.arange(1, dims + 1, dtype=f0.dtype, device=f0.device)[None, :, None]
    # (B, dims, T): both cumsums run along the last, contiguous axis, where
    # CUDA scans in parallel; along a strided axis it adds each harmonic's
    # samples one by one in float32, slowly and with a drifting phase
    rad = torch.fmod(f0.transpose(1, 2) * mult / sample_rate, 1.0)
    if generator is not None:
        rand_ini = draw(torch.rand, (B, dims), generator, f0.device)
        rand_ini[:, 0] = 0.0
        rad = torch.cat([rad[:, :, :1] + rand_ini[:, :, None], rad[:, :, 1:]], dim=2)
    tmp = torch.fmod(torch.cumsum(rad, dim=2), 1.0)
    wrap = (tmp[:, :, 1:] - tmp[:, :, :-1]) < 0
    shift = F.pad(torch.where(wrap, -1.0, 0.0), (1, 0))
    sines = (torch.sin(2.0 * torch.pi * torch.cumsum(rad + shift, dim=2)) * sine_amp
             ).transpose(1, 2)
    uv = (f0 > voiced_threshold).to(f0.dtype)
    noise_amp = uv * noise_std + (1.0 - uv) * (sine_amp / 3.0)
    if generator is None:
        return sines * uv
    return sines * uv + noise_amp * draw(torch.randn, sines.shape, generator, f0.device)


class SourceModuleAudioRate(nn.Module):
    """Audio-rate harmonic source -> tanh(Linear) merge."""

    def __init__(self, sample_rate: int, harmonic_num: int = 0):
        super().__init__()
        self.sample_rate = sample_rate
        self.harmonic_num = harmonic_num
        self.l_linear = nn.Linear(harmonic_num + 1, 1)

    def forward(self, f0: torch.Tensor, generator: Optional[torch.Generator] = None):
        s = audio_rate_sines(f0, self.sample_rate, self.harmonic_num, generator=generator)
        return torch.tanh(self.l_linear(s))


class MRFLayer(nn.Module):
    def __init__(self, channels: int, kernel_size: int, dilation: int):
        super().__init__()
        k, d = kernel_size, dilation
        self.conv1 = Conv1d(channels, channels, k, padding=(k * d - d) // 2, dilation=d)
        self.conv2 = Conv1d(channels, channels, k, padding=k // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(leaky_relu(self.conv1(leaky_relu(x))))


class MRFBlock(nn.Module):
    def __init__(self, channels: int, kernel_size: int, dilations: Sequence[int]):
        super().__init__()
        self.layers = nn.ModuleList(MRFLayer(channels, kernel_size, d) for d in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class HiFiGANMRFGenerator(nn.Module):
    """MRF NSF generator (`hifigan_mrf.py:223`): latent (B, T, C) + frame
    f0 (B, T) -> waveform (B, T*upp, 1)."""

    def __init__(self, in_channel: int, upsample_initial_channel: int,
                 upsample_rates: Sequence[int], upsample_kernel_sizes: Sequence[int],
                 resblock_kernel_sizes: Sequence[int],
                 resblock_dilations: Sequence[Sequence[int]], gin_channels: int,
                 sample_rate: int, harmonic_num: int = 8):
        super().__init__()
        rates = list(upsample_rates)
        self.upp = math.prod(rates)
        self.m_source = SourceModuleAudioRate(sample_rate, harmonic_num)
        self.conv_pre = Conv1d(in_channel, upsample_initial_channel, 7, padding=3)
        self.cond = Conv1d(gin_channels, upsample_initial_channel, 1)
        self.upsamples = nn.ModuleList()
        self.noise_convs = nn.ModuleList()
        self.mrfs = nn.ModuleList()
        ch = upsample_initial_channel
        for i, (u, k) in enumerate(zip(rates, upsample_kernel_sizes)):
            new_ch = upsample_initial_channel // (2 ** (i + 1))
            pad = (k - u) // 2 if u % 2 == 0 else u // 2 + u % 2
            self.upsamples.append(ConvTranspose1d(ch, new_ch, k, stride=u, padding=pad,
                                                  output_padding=u % 2))
            stride_f0 = math.prod(rates[i + 1:]) if i + 1 < len(rates) else 1
            nk = 1 if stride_f0 == 1 else stride_f0 * 2 - stride_f0 % 2
            self.noise_convs.append(Conv1d(1, new_ch, nk, stride=stride_f0,
                                           padding=0 if stride_f0 == 1 else (nk - stride_f0) // 2))
            self.mrfs.append(nn.ModuleList(
                MRFBlock(new_ch, rk, tuple(rd))
                for rk, rd in zip(resblock_kernel_sizes, resblock_dilations)))
            ch = new_ch
        self.conv_post = Conv1d(ch, 1, 7, padding=3)
        init_normal(self.upsamples)

    def forward(self, x: torch.Tensor, f0: torch.Tensor, g: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        f0_up = f0[:, :, None].repeat_interleave(self.upp, dim=1)
        har = self.m_source(f0_up, generator)
        x = self.conv_pre(x)
        if g is not None:
            x = x + self.cond(g)
        for up, noise_conv, blocks in zip(self.upsamples, self.noise_convs, self.mrfs):
            x = up(leaky_relu(x))
            n = noise_conv(har)
            m = min(x.shape[1], n.shape[1])
            x = x[:, :m] + n[:, :m]
            x = sum(b(x) for b in blocks) / len(blocks)
        return torch.tanh(self.conv_post(leaky_relu(x, 0.01)))


# ---------------------------------------------------------------------------
# RefineGAN
# ---------------------------------------------------------------------------


@lru_cache(maxsize=16)
def _sinc_kernel(factor: int, width: int, rolloff: float, beta: float, device: str):
    """The decimation's lowpass taps (2 width factor + 1,), float32, summing
    to 1, made in float64 numpy as in the reference. Made outside inference
    mode, so that training may use the cached tensor after a conversion."""
    cutoff = rolloff * 0.5 / factor
    half = width * factor
    t = np.arange(-half, half + 1, dtype=np.float64)
    sinc = 2 * cutoff * np.sinc(2 * cutoff * t)
    win = np.kaiser(2 * half + 1, beta)
    kernel = (sinc * win).astype(np.float32)
    kernel = kernel / kernel.sum()
    with torch.inference_mode(False):
        return torch.from_numpy(kernel).to(device)


def kaiser_sinc_decimate(x: torch.Tensor, factor: int, width: int = 64,
                         rolloff: float = 0.9475937167399596,
                         beta: float = 14.769656459379492) -> torch.Tensor:
    """Anti-aliased integer decimation: a Kaiser-windowed sinc lowpass as a
    depthwise conv of stride `factor`, padded by its half width.
    x (B, T, C) -> (B, ceil(T / factor), C)."""
    if factor == 1:
        return x
    C = x.shape[-1]
    kernel = _sinc_kernel(factor, width, rolloff, beta, str(x.device))
    w = kernel.to(x.dtype)[None, None, :].expand(C, 1, -1)
    return F.conv1d(x.transpose(1, 2), w, stride=factor, padding=width * factor,
                    groups=C).transpose(1, 2)


def linear_resize(x: torch.Tensor, new_t: int) -> torch.Tensor:
    """Linear interpolation along time of (B, T, C) to new_t >= T samples:
    `jax.image.resize(..., "linear")`, which upsamples with half-sample
    centres and the edge samples held (`F.interpolate`, align_corners=False)."""
    if new_t < x.shape[1]:
        raise ValueError(f"linear_resize upsamples only ({x.shape[1]} -> {new_t})")
    return F.interpolate(x.transpose(1, 2), size=new_t, mode="linear",
                         align_corners=False).transpose(1, 2)


class RefineResBlock(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 7,
                 dilations: Sequence[int] = (1, 3, 5), slope: float = 0.2):
        super().__init__()
        k = kernel_size
        self.slope = slope
        self.convs1 = nn.ModuleList(
            Conv1d(channels, channels, k, padding=(k * d - d) // 2, dilation=d)
            for d in dilations)
        self.convs2 = nn.ModuleList(
            Conv1d(channels, channels, k, padding=(k - 1) // 2) for _ in dilations)
        init_normal(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            x = x + c2(leaky_relu(c1(leaky_relu(x, self.slope)), self.slope))
        return x


class AdaIN(nn.Module):
    """x + noise * weight (per channel), then LReLU; the noise is drawn
    from `generator`, and with none there is no noise."""

    def __init__(self, channels: int, slope: float = 0.2):
        super().__init__()
        self.slope = slope
        self.weight = nn.Parameter(torch.full((channels,), 1e-4))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        if generator is not None:
            x = x + draw(torch.randn, x.shape, generator, x.device) * self.weight
        return leaky_relu(x, self.slope)


class ParallelResBlock(nn.Module):
    """input conv, then the mean over kernel sizes of AdaIN -> RefineResBlock
    -> AdaIN (upstream's `blocks.J` Sequential: 0, 1, 2)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_sizes: Sequence[int] = (3, 7, 11),
                 dilations: Sequence[int] = (1, 3, 5), slope: float = 0.2):
        super().__init__()
        self.input_conv = Conv1d(in_channels, out_channels, 7, padding=3)
        init_normal(self.input_conv)
        self.blocks = nn.ModuleList(
            nn.ModuleList([AdaIN(out_channels, slope),
                           RefineResBlock(out_channels, k, tuple(dilations), slope),
                           AdaIN(out_channels, slope)])
            for k in kernel_sizes)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        x = self.input_conv(x)
        outs = [a2(res(a1(x, generator)), generator) for a1, res, a2 in self.blocks]
        return sum(outs) / len(outs)


class _MergeSource(nn.Module):
    """Holds the sine template's 1 -> 1 merge as upstream's `m_source.merge.0`."""

    def __init__(self):
        super().__init__()
        self.merge = nn.Sequential(nn.Linear(1, 1, bias=False))


class RefineGANGenerator(nn.Module):
    """RefineGAN (`refinegan.py:268`): a sine template at audio rate is
    decimated stage by stage (the taps kept as skips), then fused with the
    latent stream through linear upsampling and ParallelResBlocks.
    mel (B, T, num_mels) + frame f0 (B, T) -> waveform (B, T*upp, 1)."""

    def __init__(self, sample_rate: int = 44100, upsample_rates: Sequence[int] = (8, 8, 2, 2),
                 num_mels: int = 128, upsample_initial_channel: int = 512,
                 gin_channels: int = 256, slope: float = 0.2):
        super().__init__()
        self.sample_rate = sample_rate
        self.rates = list(upsample_rates)
        self.upp = math.prod(self.rates)
        self.slope = slope
        self.m_source = _MergeSource()
        # upstream fixes 16 start channels, upsample_initial_channel / 2^(rates
        # + 1) at its one size (512, 4 rates); the reference derives it
        start = max(upsample_initial_channel // (2 ** (len(self.rates) + 1)), 2)
        self.pre_conv = Conv1d(1, start, 7, padding=3)
        self.downsample_blocks = nn.ModuleList()
        ch = start
        for _ in self.rates:
            self.downsample_blocks.append(Conv1d(ch, ch * 2, 7, padding=3))
            ch *= 2
        c = upsample_initial_channel
        self.mel_conv = Conv1d(num_mels, c // 2, 7, padding=3)
        init_normal(self.mel_conv)
        self.cond = Conv1d(gin_channels, c // 2, 1)
        self.upsample_conv_blocks = nn.ModuleList()
        channels = c
        for _ in self.rates:
            self.upsample_conv_blocks.append(
                ParallelResBlock(channels + channels // 4, channels // 2, slope=slope))
            channels //= 2
        self.conv_post = Conv1d(channels, 1, 7, padding=3, bias=False)
        init_normal(self.conv_post)

    def forward(self, mel: torch.Tensor, f0: torch.Tensor, g: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        with trace_span("decoder/source"):
            f0_up = linear_resize(f0[:, :, None].float(), mel.shape[1] * self.upp)
            sines = audio_rate_sines(f0_up, self.sample_rate, 0, generator=generator)
            x = self.pre_conv(torch.tanh(self.m_source.merge(sines)))
            downs = []
            for i, block in enumerate(self.downsample_blocks):
                x = leaky_relu(x, self.slope)
                downs.append(x)
                x = block(kaiser_sinc_decimate(x, self.rates[-i - 1]))
        m = self.mel_conv(mel)
        if g is not None:
            m = m + self.cond(g)
        x = torch.cat([m, x], dim=-1)
        for rate, block, d in zip(self.rates, self.upsample_conv_blocks, reversed(downs)):
            with trace_span("decoder/stage"):
                x = refine_stage(x, d, rate, block, self.slope, generator)
        return torch.tanh(self.conv_post(leaky_relu(x, self.slope)))


def refine_stage(x: torch.Tensor, skip: torch.Tensor, rate: int, block: ParallelResBlock,
                 slope: float, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One RefineGAN upsampling stage: x (B, T, C) through LReLU, linearly
    resized to T * rate, cut to the skip tap's length and joined with it
    (B, T * rate, C + C / 4), then the ParallelResBlock -> (B, T * rate, C / 2)."""
    x = linear_resize(leaky_relu(x, slope), x.shape[1] * rate)
    n = min(skip.shape[1], x.shape[1])
    return block(torch.cat([x[:, :n], skip[:, :n]], dim=-1), generator)
