"""The RVC Synthesizer, inference only (counterpart of
`rvc_tpu/models/synthesizer.py`): enc_p -> flow reverse -> decoder. An f0
model's decoder is the one `vocoder` names: "MRF HiFi-GAN", "RefineGAN"
(`generators_extra.py`), or else the NSF HiFi-GAN; f0-less models take the
plain HiFi-GAN, whatever `vocoder` says.

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
from rvc_tpu_torch.models.generators import HiFiGANGenerator, HiFiGANNSFGenerator
from rvc_tpu_torch.models.generators_extra import HiFiGANMRFGenerator, RefineGANGenerator

SOURCE_NOISE_SEED = 0x5EED


class Synthesizer(nn.Module):
    def __init__(self, model: ModelConfig, sr: int):
        super().__init__()
        m = model
        self.use_f0 = m.use_f0
        self.enc_p = TextEncoder(m.inter_channels, m.hidden_channels, m.filter_channels,
                                 m.n_heads, m.n_layers, m.kernel_size,
                                 embedding_dim=m.text_enc_hidden_dim, use_f0=m.use_f0)
        self.flow = ResidualCouplingBlock(m.inter_channels, m.hidden_channels, 5, 1, 3,
                                          gin_channels=m.gin_channels)
        dec_args = (m.inter_channels, m.resblock_kernel_sizes, m.resblock_dilation_sizes,
                    m.upsample_rates, m.upsample_initial_channel, m.upsample_kernel_sizes,
                    m.gin_channels)
        if not m.use_f0:
            self.dec = HiFiGANGenerator(*dec_args)
        elif m.vocoder == "MRF HiFi-GAN":
            self.dec = HiFiGANMRFGenerator(
                m.inter_channels, m.upsample_initial_channel, m.upsample_rates,
                m.upsample_kernel_sizes, m.resblock_kernel_sizes, m.resblock_dilation_sizes,
                m.gin_channels, sr, harmonic_num=8)
        elif m.vocoder == "RefineGAN":
            self.dec = RefineGANGenerator(sr, m.upsample_rates, m.inter_channels,
                                          m.upsample_initial_channel, m.gin_channels)
        else:
            self.dec = HiFiGANNSFGenerator(*dec_args, sr)
        self.emb_g = nn.Embedding(m.spk_embed_dim, m.gin_channels)

    def infer(self, phone: torch.Tensor, phone_lengths: torch.Tensor,
              pitch: Optional[torch.Tensor], nsff0: Optional[torch.Tensor], sid: torch.Tensor,
              generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """phone (B, T, 768), lengths (B,), coarse pitch (B, T), f0 (B, T),
        sid (B,) -> (wave (B, T*upp, 1), x_mask (B, T, 1)).

        The prior noise scale is 0, as in the reference's pipeline;
        `generator` draws the decoder's noise (the source's, and RefineGAN's
        AdaIN; None: no noise). An f0-less model takes no pitch and no f0
        (both None).
        """
        if self.use_f0 and nsff0 is None:
            raise ValueError("an f0 model's NSF decoder needs the f0 (nsff0)")
        g = self.emb_g(sid)[:, None, :]
        m_p, _, x_mask = self.enc_p(phone, pitch, phone_lengths)
        z = self.flow(m_p * x_mask, x_mask, g=g)
        z, g = (z * x_mask).float(), g.float()
        o = self.dec(z, nsff0, g=g, generator=generator) if self.use_f0 else self.dec(z, g=g)
        return o, x_mask


def build_synthesizer(cfg: RVCConfig, sr: Optional[int] = None) -> Synthesizer:
    return Synthesizer(cfg.model, sr or cfg.data.sample_rate)
