"""Core layers on the reference's (B, T, C) / (B, H, W, C) layout
(counterpart of `rvc_tpu/models/layers.py`).

Parameters keep torch's layouts and the upstream checkpoint names
(`weight`, `bias`; `gamma`, `beta` for the VITS LayerNorm), so an upstream
state dict loads as it is; the forward passes permute them (a view) into
the reference's layout for `ops.conv`. Linear and Embedding are
`torch.nn.Linear` / `torch.nn.Embedding`, whose semantics are the
reference's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from rvc_tpu_torch.ops import conv as conv_ops
from rvc_tpu_torch.ops.commons import fused_add_tanh_sigmoid_multiply
from rvc_tpu_torch.ops.kernels.resblock import resblock_chain, resblock_chain_tp
from rvc_tpu_torch.parallel.tp import local_slice

LRELU_SLOPE = 0.1


def leaky_relu(x: torch.Tensor, slope: float = LRELU_SLOPE) -> torch.Tensor:
    return torch.where(x >= 0, x, x * slope)


def init_normal(module: nn.Module, std: float = 0.01) -> None:
    """Upstream HiFi-GAN `init_weights`: conv weights ~ N(0, std)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
            nn.init.normal_(m.weight, 0.0, std)


class Conv1d(nn.Conv1d):
    """1-D conv on (B, T, Cin); weight (Cout, Cin // groups, K)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_ops.conv1d(x, self.weight.permute(2, 1, 0), self.bias,
                               stride=self.stride[0], padding=self.padding[0],
                               dilation=self.dilation[0], groups=self.groups)


class ConvTranspose1d(nn.ConvTranspose1d):
    """Transposed 1-D conv on (B, T, Cin); weight (Cin, Cout, K)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_ops.conv_transpose1d(
            x, self.weight.permute(2, 0, 1), self.bias, stride=self.stride[0],
            padding=self.padding[0], output_padding=self.output_padding[0])


class Conv2d(nn.Conv2d):
    """2-D conv on (B, H, W, Cin); weight (Cout, Cin // groups, KH, KW)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_ops.conv2d(x, self.weight.permute(2, 3, 1, 0), self.bias,
                               stride=self.stride, padding=self.padding,
                               dilation=self.dilation, groups=self.groups)


class ConvTranspose2d(nn.ConvTranspose2d):
    """Transposed 2-D conv on (B, H, W, Cin); weight (Cin, Cout, KH, KW)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_ops.conv_transpose2d(
            x, self.weight.permute(2, 3, 0, 1), self.bias, stride=self.stride,
            padding=self.padding, output_padding=self.output_padding)


class BatchNorm(nn.Module):
    """Inference-mode batch norm over the last (channel) axis, with torch's
    BatchNorm parameter and buffer names."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + self.eps)
        return (x - self.running_mean) * inv * self.weight + self.bias


class LayerNorm(nn.Module):
    """Channel-last layer norm with the VITS parameter names gamma / beta."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn.functional.layer_norm(x, x.shape[-1:], self.gamma, self.beta, self.eps)


class WaveNet(nn.Module):
    """Gated dilated conv stack with one shared conditioning layer
    (`rvc_tpu/models/layers.py:WaveNet`)."""

    def __init__(self, hidden_channels: int, kernel_size: int, dilation_rate: int,
                 n_layers: int, gin_channels: int = 0):
        super().__init__()
        self.hidden_channels = hidden_channels
        self.n_layers = n_layers
        H = hidden_channels
        if gin_channels:
            self.cond_layer = Conv1d(gin_channels, 2 * H * n_layers, 1)
        self.in_layers = nn.ModuleList()
        self.res_skip_layers = nn.ModuleList()
        for i in range(n_layers):
            d = dilation_rate ** i
            self.in_layers.append(Conv1d(H, 2 * H, kernel_size, dilation=d,
                                         padding=(kernel_size * d - d) // 2))
            self.res_skip_layers.append(Conv1d(H, 2 * H if i < n_layers - 1 else H, 1))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        H = self.hidden_channels
        output = torch.zeros_like(x)
        if g is not None:
            g = self.cond_layer(g)
        for i in range(self.n_layers):
            x_in = self.in_layers[i](x)
            g_l = g[:, :, i * 2 * H:(i + 1) * 2 * H] if g is not None else torch.zeros_like(x_in)
            res_skip = self.res_skip_layers[i](fused_add_tanh_sigmoid_multiply(x_in, g_l, H))
            if i < self.n_layers - 1:
                x = (x + res_skip[:, :, :H]) * x_mask
                output = output + res_skip[:, :, H:]
            else:
                output = output + res_skip
        return output * x_mask


class ResBlock(nn.Module):
    """HiFi-GAN ResBlock type 1: per dilation, LReLU -> dilated conv ->
    LReLU -> conv, with the residual. Runs through kernel K2
    (`ops.kernels.resblock.resblock_chain`); under tensor parallelism (`tp`
    set: convs1 column-parallel, convs2 row-parallel) through its
    partial-sum launch (`resblock_chain_tp`)."""

    tp = None    # the model Axis where the chain runs tensor-parallel

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: Sequence[int] = (1, 3, 5)):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilations = tuple(dilations)
        self.convs1 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, dilation=d,
                   padding=(kernel_size * d - d) // 2) for d in dilations)
        self.convs2 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, padding=(kernel_size - 1) // 2)
            for _ in dilations)

    def tp_pair(self, model_size: int):
        return (tuple(f"convs1.{i}.weight" for i in range(len(self.convs1))),
                tuple(f"convs2.{i}.weight" for i in range(len(self.convs2))))

    def stacked_weights(self) -> tuple:
        """(w1, b1, w2, b2) in the kernel's layout: w (S, K, C, C), b (S, C);
        under tensor parallelism the rank's w1 (S, K, C, C_M), b1 (S, C_M),
        w2 (S, K, C_M, C) and the whole b2."""
        out = []
        for convs in (self.convs1, self.convs2):
            out.append(torch.stack([c.weight.permute(2, 1, 0) for c in convs]))
            out.append(torch.stack([c.bias for c in convs]))
        if self.tp is not None:
            out[1] = local_slice(out[1], 1, self.tp)
        return tuple(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            return resblock_chain_tp(x, *self.stacked_weights(), self.kernel_size,
                                     self.dilations, LRELU_SLOPE, self.tp)
        return resblock_chain(x, *self.stacked_weights(), self.kernel_size,
                              self.dilations)
