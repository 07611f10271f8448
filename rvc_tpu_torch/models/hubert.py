"""HuBERT / ContentVec content encoder (counterpart of
`rvc_tpu/models/hubert.py`).

HF hubert-base layout and names, post-LN variant: a 7-layer conv feature
extractor (k 10,3,3,3,3,2,2 / s 5,2,2,2,2,2,2, 512 ch, GroupNorm(512, 512)
on layer 0 only), LayerNorm + Linear feature projection to 768, a grouped
positional conv (k 128, groups 16, pad 64, the trailing sample cropped,
GELU, residual), then 12 post-LN transformer layers. Raw 16 kHz audio
(B, T) -> features (B, T // 320, 768). The reference has no Pallas kernel
here; attention is plain matmuls with a float32 softmax.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from rvc_tpu_torch.models.layers import Conv1d

_CONV_KERNELS = (10, 3, 3, 3, 3, 2, 2)
_CONV_STRIDES = (5, 2, 2, 2, 2, 2, 2)


@dataclass(frozen=True)
class HubertConfig:
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-5
    conv_dim: int = 512
    classifier_proj_size: int = 768  # 768 = no projection (v2); 256 = v1
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


class ConvLayer(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, s: int, group_norm: bool):
        super().__init__()
        self.conv = Conv1d(cin, cout, k, stride=s, bias=False)
        if group_norm:
            self.layer_norm = nn.GroupNorm(cout, cout, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv(x)
        if hasattr(self, "layer_norm"):
            h = self.layer_norm(h.transpose(1, 2)).transpose(1, 2)
        return F.gelu(h)


class FeatureExtractor(nn.Module):
    def __init__(self, c: HubertConfig):
        super().__init__()
        self.conv_layers = nn.ModuleList(
            ConvLayer(1 if i == 0 else c.conv_dim, c.conv_dim, k, s, i == 0)
            for i, (k, s) in enumerate(zip(_CONV_KERNELS, _CONV_STRIDES)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x[:, :, None]
        for layer in self.conv_layers:
            h = layer(h)
        return h


class FeatureProjection(nn.Module):
    def __init__(self, c: HubertConfig):
        super().__init__()
        self.layer_norm = nn.LayerNorm(c.conv_dim, eps=c.layer_norm_eps)
        self.projection = nn.Linear(c.conv_dim, c.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.projection(self.layer_norm(x))


class SelfAttention(nn.Module):
    def __init__(self, c: HubertConfig):
        super().__init__()
        self.n_heads = c.num_attention_heads
        self.q_proj = nn.Linear(c.hidden_size, c.hidden_size)
        self.k_proj = nn.Linear(c.hidden_size, c.hidden_size)
        self.v_proj = nn.Linear(c.hidden_size, c.hidden_size)
        self.out_proj = nn.Linear(c.hidden_size, c.hidden_size)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T, C = x.shape
        H = self.n_heads

        def split(t):
            return t.reshape(B, T, H, C // H).transpose(1, 2)

        scores = (split(self.q_proj(x)) * (C // H) ** -0.5) @ split(self.k_proj(x)).transpose(-1, -2)
        if mask is not None:
            scores = scores.masked_fill(mask == 0, -1e4)
        p = torch.softmax(scores.float(), dim=-1).to(scores.dtype)
        out = (p @ split(self.v_proj(x))).transpose(1, 2).reshape(B, T, C)
        return self.out_proj(out)


class FeedForward(nn.Module):
    def __init__(self, c: HubertConfig):
        super().__init__()
        self.intermediate_dense = nn.Linear(c.hidden_size, c.intermediate_size)
        self.output_dense = nn.Linear(c.intermediate_size, c.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class EncoderLayer(nn.Module):
    """Post-LN transformer layer (HF Hubert do_stable_layer_norm=False)."""

    def __init__(self, c: HubertConfig):
        super().__init__()
        self.attention = SelfAttention(c)
        self.layer_norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.feed_forward = FeedForward(c)
        self.final_layer_norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.layer_norm(x + self.attention(x, mask))
        return self.final_layer_norm(x + self.feed_forward(x))


class PositionalConvEmbedding(nn.Module):
    def __init__(self, c: HubertConfig):
        super().__init__()
        self.conv = Conv1d(c.hidden_size, c.hidden_size, c.pos_conv_kernel,
                           padding=c.pos_conv_kernel // 2, groups=c.pos_conv_groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + F.gelu(self.conv(x)[:, :-1, :])


class Encoder(nn.Module):
    def __init__(self, c: HubertConfig):
        super().__init__()
        self.pos_conv_embed = PositionalConvEmbedding(c)
        self.layer_norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.layers = nn.ModuleList(EncoderLayer(c) for _ in range(c.num_hidden_layers))

    def forward(self, h: torch.Tensor, attention_mask: Optional[torch.Tensor] = None):
        h = self.layer_norm(self.pos_conv_embed(h))
        mask4 = None
        if attention_mask is not None:
            m = attention_mask.to(h.dtype)
            mask4 = m[:, None, None, :] * m[:, None, :, None]
            h = h * m[:, :, None]
        for layer in self.layers:
            h = layer(h, mask4)
        return h


class HubertModel(nn.Module):
    def __init__(self, config: HubertConfig = HubertConfig()):
        super().__init__()
        self.config = config
        self.feature_extractor = FeatureExtractor(config)
        self.feature_projection = FeatureProjection(config)
        self.encoder = Encoder(config)
        if config.classifier_proj_size != config.hidden_size:
            self.final_proj = nn.Linear(config.hidden_size, config.classifier_proj_size)

    def forward(self, input_values: torch.Tensor, output_hidden_states: bool = True,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T_samples) 16 kHz -> (B, T_frames, 768 | classifier_proj_size)."""
        h = self.encoder(self.feature_projection(self.feature_extractor(input_values)),
                         attention_mask)
        if output_hidden_states or not hasattr(self, "final_proj"):
            return h
        return self.final_proj(h)
