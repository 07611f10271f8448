"""NSF-HiFiGAN decoder (counterpart of `rvc_tpu/models/generators.py`,
canonical branch).

The ResBlocks of each upsampling stage run through the decoder kernels,
dispatched as in the reference (`_stage_resblocks`): a stage with C <= 128
is one call of K1 (`resblock_group`, the mean over its parallel chains);
the C = 256 first stage runs K2 (`resblock_chain`) once per ResBlock and
then takes the mean. Both decoders share that dispatch: the NSF
HiFi-GAN of f0 models and the plain HiFi-GAN of f0-less ones. The
reference's packed-lane tail (`ops/packed_tail.py`) is a TPU layout of the
same function and has no counterpart here.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from rvc_tpu_torch.models.layers import (
    LRELU_SLOPE,
    Conv1d,
    ConvTranspose1d,
    ResBlock,
    init_normal,
    leaky_relu,
)
from rvc_tpu_torch.ops.commons import draw
from rvc_tpu_torch.ops.kernels.resblock import resblock_group, resblock_group_tp

GROUP_MAX_CHANNELS = 128


@torch.no_grad()
def round_params_bf16_(module: nn.Module) -> nn.Module:
    """Round every floating parameter of `module` through bf16, in place,
    keeping float32: the decoder under the bf16 compute policy. The
    reference casts the whole synthesizer's parameters to bf16 and the
    decoder upcasts them at use on float32 activations, so its convs, the
    source's linear, and K1/K2's weights and biases see these values (K1/K2
    round their weights to bf16 themselves, but take their biases as
    given)."""
    for p in module.parameters():
        if p.is_floating_point():
            p.copy_(p.to(torch.bfloat16))
    return module


def _stage_resblocks(x: torch.Tensor, blocks: Sequence[ResBlock],
                     kernel_sizes: Tuple[int, ...],
                     dilations: Tuple[Tuple[int, ...], ...]) -> torch.Tensor:
    """The mean of one upsampling stage's parallel ResBlocks: one K1 call at
    C <= 128, else K2 once per ResBlock. Under tensor parallelism a stage
    with a sharded ResBlock takes K1's partial-sum call, `resblock_group_tp`
    (its whole chains run K1 as before)."""
    if x.shape[-1] <= GROUP_MAX_CHANNELS:
        weights = tuple(t for b in blocks for t in b.stacked_weights())
        tp = next((b.tp for b in blocks if b.tp is not None), None)
        if tp is not None:
            return resblock_group_tp(x, weights, kernel_sizes, dilations, LRELU_SLOPE, tp)
        return resblock_group(x, weights, kernel_sizes, dilations)
    return sum(b(x) for b in blocks) / len(blocks)


def sine_source(f0: torch.Tensor, upp: int, sample_rate: int, harmonic_num: int = 0,
                sine_amp: float = 0.1, noise_std: float = 0.003,
                voiced_threshold: float = 0.0,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frame-rate f0 (B, L) -> audio-rate sine source (B, L*upp, H+1) and
    the voiced mask, both float32.

    The phase accumulates across frames through an fmod-remainder cumsum,
    so sines stay continuous at frame boundaries. The additive noise is
    `noise` if given, else drawn from `generator`, else zero (the reference
    draws it from a fixed JAX key that torch cannot reproduce; tests pass
    both the same numpy noise or turn it off).
    """
    B, L = f0.shape
    f0 = f0.float()
    n_harm = harmonic_num + 1
    grid = torch.arange(1, upp + 1, dtype=torch.float32, device=f0.device)
    phase_inc = (f0[:, :, None] / sample_rate) * grid                # (B, L, upp)
    rem = torch.fmod(phase_inc[:, :-1, -1] + 0.5, 1.0) - 0.5
    cum = nn.functional.pad(torch.fmod(torch.cumsum(rem, dim=1), 1.0), (1, 0))
    phase = (phase_inc + cum[:, :, None]).reshape(B, L * upp, 1)
    phase = phase * torch.arange(1, n_harm + 1, dtype=torch.float32, device=f0.device)
    if n_harm > 1 and generator is not None:
        rand = torch.rand(n_harm - 1, generator=generator, device=f0.device)
        phase = phase + nn.functional.pad(rand, (1, 0))
    sines = torch.sin(2.0 * torch.pi * phase) * sine_amp
    voiced = (f0 > voiced_threshold).float()[:, :, None].repeat_interleave(upp, dim=1)
    noise_amp = voiced * noise_std + (1.0 - voiced) * (sine_amp / 3.0)
    if noise is None:
        noise = (draw(torch.randn, sines.shape, generator, f0.device)
                 if generator is not None else torch.zeros_like(sines))
    return sines * voiced + noise_amp * noise, voiced


class SourceModuleHnNSF(nn.Module):
    """Harmonic-plus-noise source: sine bank -> Linear -> tanh."""

    def __init__(self, sample_rate: int, harmonic_num: int = 0, sine_amp: float = 0.1,
                 add_noise_std: float = 0.003, voiced_threshold: float = 0.0):
        super().__init__()
        self.sample_rate = sample_rate
        self.harmonic_num = harmonic_num
        self.sine_amp = sine_amp
        self.noise_std = add_noise_std
        self.voiced_threshold = voiced_threshold
        self.l_linear = nn.Linear(harmonic_num + 1, 1)

    def forward(self, f0: torch.Tensor, upp: int,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        src, _ = sine_source(f0, upp, self.sample_rate, self.harmonic_num,
                             self.sine_amp, self.noise_std, self.voiced_threshold,
                             generator, noise)
        return torch.tanh(self.l_linear(src))


class HiFiGANNSFGenerator(nn.Module):
    """latent (B, T, C) + frame f0 (B, T) -> waveform (B, T*upp, 1)."""

    def __init__(self, initial_channel: int, resblock_kernel_sizes: Sequence[int],
                 resblock_dilation_sizes: Sequence[Sequence[int]],
                 upsample_rates: Sequence[int], upsample_initial_channel: int,
                 upsample_kernel_sizes: Sequence[int], gin_channels: int, sr: int):
        super().__init__()
        self.kernel_sizes = tuple(resblock_kernel_sizes)
        self.dilations = tuple(tuple(d) for d in resblock_dilation_sizes)
        self.upp = math.prod(upsample_rates)
        rates = list(upsample_rates)
        self.chans = [upsample_initial_channel // (2 ** (i + 1)) for i in range(len(rates))]
        self.m_source = SourceModuleHnNSF(sr, harmonic_num=0)
        self.conv_pre = Conv1d(initial_channel, upsample_initial_channel, 7, padding=3)
        self.cond = Conv1d(gin_channels, upsample_initial_channel, 1)
        self.ups = nn.ModuleList()
        self.noise_convs = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(rates, upsample_kernel_sizes)):
            pad = (k - u) // 2 if u % 2 == 0 else u // 2 + u % 2
            self.ups.append(ConvTranspose1d(upsample_initial_channel // (2 ** i),
                                            self.chans[i], k, stride=u, padding=pad,
                                            output_padding=u % 2))
            stride_f0 = math.prod(rates[i + 1:]) if i + 1 < len(rates) else 1
            nk = 1 if stride_f0 == 1 else stride_f0 * 2 - stride_f0 % 2
            self.noise_convs.append(Conv1d(1, self.chans[i], nk, stride=stride_f0,
                                           padding=0 if stride_f0 == 1 else (nk - stride_f0) // 2))
            for ks, ds in zip(self.kernel_sizes, self.dilations):
                self.resblocks.append(ResBlock(self.chans[i], ks, ds))
        self.conv_post = Conv1d(self.chans[-1], 1, 7, padding=3, bias=False)
        init_normal(self.ups)
        init_normal(self.resblocks)

    def forward(self, x: torch.Tensor, f0: torch.Tensor,
                g: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """noise: the source's standard normal draw (B, T*upp, 1), in place
        of one from `generator`."""
        har_source = self.m_source(f0, self.upp, generator, noise)  # (B, T*upp, 1)
        x = self.conv_pre(x)
        if g is not None:
            x = x + self.cond(g)
        for i, (up, noise_conv) in enumerate(zip(self.ups, self.noise_convs)):
            x = up(leaky_relu(x))
            n = noise_conv(har_source)
            m = min(x.shape[1], n.shape[1])
            x = x[:, :m] + n[:, :m]
            n = len(self.kernel_sizes)
            x = _stage_resblocks(x, self.resblocks[i * n:(i + 1) * n], self.kernel_sizes,
                                 self.dilations)
        # the default torch leaky_relu slope at the tail
        return torch.tanh(self.conv_post(leaky_relu(x, 0.01)))


class HiFiGANGenerator(nn.Module):
    """Plain HiFi-GAN of f0-less models, no source: latent (B, T, C) ->
    waveform (B, T*upp, 1) (`rvc_tpu/models/generators.py:HiFiGANGenerator`,
    upstream `rvc/lib/algorithm/generators/hifigan.py`). Its upsampling
    convs pad (k - u) // 2 with no output padding, unlike the NSF decoder's
    for odd u."""

    def __init__(self, initial_channel: int, resblock_kernel_sizes: Sequence[int],
                 resblock_dilation_sizes: Sequence[Sequence[int]],
                 upsample_rates: Sequence[int], upsample_initial_channel: int,
                 upsample_kernel_sizes: Sequence[int], gin_channels: int):
        super().__init__()
        self.kernel_sizes = tuple(resblock_kernel_sizes)
        self.dilations = tuple(tuple(d) for d in resblock_dilation_sizes)
        self.upp = math.prod(upsample_rates)
        chans = [upsample_initial_channel // (2 ** (i + 1)) for i in range(len(upsample_rates))]
        self.conv_pre = Conv1d(initial_channel, upsample_initial_channel, 7, padding=3)
        self.cond = Conv1d(gin_channels, upsample_initial_channel, 1)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            self.ups.append(ConvTranspose1d(upsample_initial_channel // (2 ** i), chans[i], k,
                                            stride=u, padding=(k - u) // 2))
            for ks, ds in zip(self.kernel_sizes, self.dilations):
                self.resblocks.append(ResBlock(chans[i], ks, ds))
        self.conv_post = Conv1d(chans[-1], 1, 7, padding=3, bias=False)
        init_normal(self.ups)
        init_normal(self.resblocks)

    def forward(self, x: torch.Tensor, g: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.conv_pre(x)
        if g is not None:
            x = x + self.cond(g)
        n = len(self.kernel_sizes)
        for i, up in enumerate(self.ups):
            x = _stage_resblocks(up(leaky_relu(x)), self.resblocks[i * n:(i + 1) * n],
                                 self.kernel_sizes, self.dilations)
        return torch.tanh(self.conv_post(leaky_relu(x, 0.01)))
