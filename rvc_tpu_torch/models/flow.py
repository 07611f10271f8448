"""Normalizing flow (counterpart of `rvc_tpu/models/flow.py`).

As upstream, `flows` interleaves coupling layers (indices 0, 2, 4, 6) with
parameter-free channel flips, so the state dict keys match. Reverse (the
default: inference) runs the list backwards, which puts each flip BEFORE
its coupling layer; forward (training: the posterior into prior space)
runs it in order.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from rvc_tpu_torch.models.layers import Conv1d, WaveNet


class ResidualCouplingLayer(nn.Module):
    """Mean-only residual coupling layer."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int = 5,
                 dilation_rate: int = 1, n_layers: int = 3, gin_channels: int = 0):
        super().__init__()
        self.half = channels // 2
        self.pre = Conv1d(self.half, hidden_channels, 1)
        self.enc = WaveNet(hidden_channels, kernel_size, dilation_rate, n_layers,
                           gin_channels)
        self.post = Conv1d(hidden_channels, self.half, 1)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None, reverse: bool = True) -> torch.Tensor:
        """The coupling x1 <- (m(x0) + x1) * mask, or in reverse its inverse
        x1 <- (x1 - m(x0)) * mask."""
        x0, x1 = x[..., :self.half], x[..., self.half:]
        h = self.enc(self.pre(x0) * x_mask, x_mask, g=g)
        m = self.post(h) * x_mask
        x1 = (x1 - m) * x_mask if reverse else (m + x1) * x_mask
        return torch.cat([x0, x1], dim=-1)


class Flip(nn.Module):
    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None, reverse: bool = True) -> torch.Tensor:
        return torch.flip(x, dims=(-1,))


class ResidualCouplingBlock(nn.Module):
    def __init__(self, channels: int, hidden_channels: int, kernel_size: int = 5,
                 dilation_rate: int = 1, n_layers: int = 3, n_flows: int = 4,
                 gin_channels: int = 0):
        super().__init__()
        self.flows = nn.ModuleList()
        for _ in range(n_flows):
            self.flows.append(ResidualCouplingLayer(
                channels, hidden_channels, kernel_size, dilation_rate, n_layers,
                gin_channels))
            self.flows.append(Flip())

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None, reverse: bool = True) -> torch.Tensor:
        """Reverse: latent z_p (B, T, C) -> z; forward: z -> z_p."""
        for flow in (reversed(self.flows) if reverse else self.flows):
            x = flow(x, x_mask, g=g, reverse=reverse)
        return x
