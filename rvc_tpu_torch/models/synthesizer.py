"""The RVC Synthesizer, inference only (counterpart of
`rvc_tpu/models/synthesizer.py`): enc_p -> flow reverse -> NSF-HiFiGAN.

Module names are the upstream torch checkpoint's (`enc_p`, `flow`, `dec`,
`emb_g`). The posterior encoder enc_q is training-only and absent.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from rvc_tpu_torch.configs import ModelConfig, RVCConfig
from rvc_tpu_torch.models.encoders import TextEncoder
from rvc_tpu_torch.models.flow import ResidualCouplingBlock
from rvc_tpu_torch.models.generators import HiFiGANNSFGenerator

SOURCE_NOISE_SEED = 0x5EED


class Synthesizer(nn.Module):
    def __init__(self, model: ModelConfig, sr: int):
        super().__init__()
        if not model.use_f0 or model.vocoder != "HiFi-GAN":
            raise NotImplementedError(
                "only the NSF HiFi-GAN decoder (use_f0, vocoder 'HiFi-GAN') is ported")
        m = model
        self.enc_p = TextEncoder(m.inter_channels, m.hidden_channels, m.filter_channels,
                                 m.n_heads, m.n_layers, m.kernel_size,
                                 embedding_dim=m.text_enc_hidden_dim, use_f0=m.use_f0)
        self.flow = ResidualCouplingBlock(m.inter_channels, m.hidden_channels, 5, 1, 3,
                                          gin_channels=m.gin_channels)
        self.dec = HiFiGANNSFGenerator(m.inter_channels, m.resblock_kernel_sizes,
                                       m.resblock_dilation_sizes, m.upsample_rates,
                                       m.upsample_initial_channel,
                                       m.upsample_kernel_sizes, m.gin_channels, sr)
        self.emb_g = nn.Embedding(m.spk_embed_dim, m.gin_channels)

    def infer(self, phone: torch.Tensor, phone_lengths: torch.Tensor,
              pitch: Optional[torch.Tensor], nsff0: torch.Tensor, sid: torch.Tensor,
              generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """phone (B, T, 768), lengths (B,), coarse pitch (B, T), f0 (B, T),
        sid (B,) -> (wave (B, T*upp, 1), x_mask (B, T, 1)).

        The prior noise scale is 0, as in the reference's pipeline;
        `generator` draws the NSF source noise (None: no noise).
        """
        g = self.emb_g(sid)[:, None, :]
        m_p, _, x_mask = self.enc_p(phone, pitch, phone_lengths)
        z = self.flow(m_p * x_mask, x_mask, g=g)
        o = self.dec((z * x_mask).float(), nsff0, g=g.float(), generator=generator)
        return o, x_mask


def build_synthesizer(cfg: RVCConfig, sr: Optional[int] = None) -> Synthesizer:
    return Synthesizer(cfg.model, sr or cfg.data.sample_rate)
