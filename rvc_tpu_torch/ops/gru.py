"""Bidirectional GRU (counterpart of `rvc_tpu/ops/gru.py`).

`torch.nn.GRU` has the gate order the reference follows, rows of
weight_ih / weight_hh as [r; z; n]:

    r = sigmoid(W_ir x + b_ir + W_hr h + b_hr)
    z = sigmoid(W_iz x + b_iz + W_hz h + b_hz)
    n = tanh(W_in x + b_in + r * (W_hn h + b_hn))
    h' = (1 - z) * n + z * h

so the reference's hand-written scan is `nn.GRU` here (no Pallas kernel
lives in it). The module keeps the upstream name `gru` for its weights.
"""

from __future__ import annotations

import torch
from torch import nn


class BiGRU(nn.Module):
    """(B, T, In) -> (B, T, 2H): forward and backward hidden sequences."""

    def __init__(self, input_features: int, hidden_features: int,
                 num_layers: int = 1):
        super().__init__()
        self.gru = nn.GRU(input_features, hidden_features, num_layers=num_layers,
                          batch_first=True, bidirectional=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.gru(x)[0]
