"""The RVC Synthesizer (counterpart of `rvc_tpu/models/synthesizer.py`).

Inference: enc_p -> flow reverse -> decoder. Training (`forward`, with
`training=True`): the prior (TextEncoder) and the posterior (enc_q, on the
linear spectrogram), the posterior flowed into prior space, a random
segment of it decoded. An f0 model's decoder is the one `vocoder` names:
"MRF HiFi-GAN", "RefineGAN" (`generators_extra.py`), or else the NSF
HiFi-GAN; f0-less models take the plain HiFi-GAN, whatever `vocoder` says.

Module names are the upstream torch checkpoint's (`enc_p`, `enc_q`, `flow`,
`dec`, `emb_g`). The posterior encoder enc_q exists only in a model built
for training: inference checkpoints carry none, and load strictly into a
model without it.
"""

from __future__ import annotations

import copy
import os
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from rvc_tpu_torch.configs import ModelConfig, RVCConfig
from rvc_tpu_torch.models.encoders import PosteriorEncoder, TextEncoder
from rvc_tpu_torch.models.flow import ResidualCouplingBlock
from rvc_tpu_torch.models.generators import (
    HiFiGANGenerator,
    HiFiGANNSFGenerator,
    round_params_bf16_,
)
from rvc_tpu_torch.models.generators_extra import HiFiGANMRFGenerator, RefineGANGenerator
from rvc_tpu_torch.ops.commons import draw, rand_slice_segments, slice_segments

SOURCE_NOISE_SEED = 0x5EED


def source_noise_on(setting: Optional[bool] = None) -> bool:
    """Whether inference draws the NSF source's noise: `setting` where it is
    given, else RVC_TPU_SOURCE_NOISE read now ("0" turns the noise off, for
    noise-free comparisons), as the reference's `source_noise_rng` reads it."""
    if setting is not None:
        return setting
    return os.environ.get("RVC_TPU_SOURCE_NOISE", "1") != "0"


class TrainOutputs(NamedTuple):
    wave: torch.Tensor       # (B, segment_frames * upp, 1) generated segment
    ids_slice: torch.Tensor  # (B,) slice start frames
    x_mask: torch.Tensor     # (B, T_enc, 1)
    y_mask: torch.Tensor     # (B, T_spec, 1)
    z: torch.Tensor
    z_p: torch.Tensor
    m_p: torch.Tensor
    logs_p: torch.Tensor
    m_q: torch.Tensor
    logs_q: torch.Tensor


class Synthesizer(nn.Module):
    """training=True adds enc_q (on spec_channels bins) and the training
    forward over segments of segment_frames frames; model.checkpointing
    then recomputes the NSF decoder in the backward pass
    (`torch.utils.checkpoint`; the reference's `nn.remat`)."""

    def __init__(self, model: ModelConfig, sr: int, *, training: bool = False,
                 spec_channels: int = 1025, segment_frames: int = 36):
        super().__init__()
        m = model
        self.use_f0 = m.use_f0
        self.segment_frames = segment_frames
        self.checkpointing = m.checkpointing
        self.enc_p = TextEncoder(m.inter_channels, m.hidden_channels, m.filter_channels,
                                 m.n_heads, m.n_layers, m.kernel_size,
                                 embedding_dim=m.text_enc_hidden_dim, use_f0=m.use_f0)
        if training:
            self.enc_q = PosteriorEncoder(spec_channels, m.inter_channels, m.hidden_channels,
                                          5, 1, 16, gin_channels=m.gin_channels)
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

    def forward(self, phone: torch.Tensor, phone_lengths: torch.Tensor,
                pitch: Optional[torch.Tensor], pitchf: Optional[torch.Tensor],
                spec: torch.Tensor, spec_lengths: torch.Tensor, sid: torch.Tensor, *,
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None, ids_slice: Optional[torch.Tensor] = None,
                source_noise: Optional[torch.Tensor] = None) -> TrainOutputs:
        """Training forward (reference `synthesizers.py:85`): phone (B, T, 768),
        lengths (B,), coarse pitch (B, T), f0 (B, T), spec (B, T, bins),
        spec lengths (B,), sid (B,).

        The draws come from `generator` (on the model's device), in the
        reference's order: the posterior's eps, the segment starts, the
        decoder's noise. eps (B, T, inter), ids_slice (B,) and, for the NSF
        HiFi-GAN, source_noise (B, segment_frames * upp, 1) may be handed in
        instead; a draw neither handed nor drawable raises. Without a
        generator the MRF and RefineGAN decoders run without noise, as at
        inference."""
        g = self.emb_g(sid)[:, None, :]
        m_p, logs_p, x_mask = self.enc_p(phone, pitch, phone_lengths)
        z, m_q, logs_q, y_mask = self.enc_q(spec, spec_lengths, g=g, generator=generator,
                                            eps=eps)
        z_p = self.flow(z, y_mask, g=g, reverse=False)
        seg = self.segment_frames
        if ids_slice is None:
            if generator is None:
                raise ValueError("the training forward needs ids_slice or a generator")
            z_slice, ids_slice = rand_slice_segments(z, spec_lengths, seg, generator)
        else:
            z_slice = slice_segments(z, ids_slice, seg)
        if not self.use_f0:
            o = self.dec(z_slice, g=g)
        elif isinstance(self.dec, HiFiGANNSFGenerator):
            if source_noise is None:
                if generator is None:
                    raise ValueError("the NSF decoder needs source_noise or a generator")
                source_noise = draw(torch.randn, (z.shape[0], seg * self.dec.upp, 1),
                                    generator, z.device)
            f0 = slice_segments(pitchf, ids_slice, seg)
            if self.checkpointing:
                o = checkpoint(self.dec, z_slice, f0, g, None, source_noise,
                               use_reentrant=False)
            else:
                o = self.dec(z_slice, f0, g, noise=source_noise)
        else:
            o = self.dec(z_slice, slice_segments(pitchf, ids_slice, seg), g=g,
                         generator=generator)
        return TrainOutputs(o, ids_slice, x_mask, y_mask, z, z_p, m_p, logs_p, m_q, logs_q)

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
        # the decoder's activations are float32 whatever the compute dtype
        # (the reference's audio-rate bf16 raised the vocoder's noise floor)
        z, g = (z * x_mask).float(), g.float()
        o = self.dec(z, nsff0, g=g, generator=generator) if self.use_f0 else self.dec(z, g=g)
        return o, x_mask


def bf16_copy(model: Synthesizer) -> Synthesizer:
    """The synthesizer under the bf16 compute policy, a copy beside the
    float32 model (on its device, no gradients): emb_g, enc_p and the flow
    in bf16; the decoder float32 on parameters rounded through bf16 (what
    the reference's parameter cast and the decoder's upcast at use compute,
    `rvc_tpu/pipelines/offline.py:301-305`, `models/synthesizer.py:159-165`).
    `infer` then runs enc_p and the flow on bf16 features and the decoder on
    float32 activations."""
    out = copy.deepcopy(model).requires_grad_(False)
    for part in (out.emb_g, out.enc_p, out.flow):
        part.to(torch.bfloat16)
    round_params_bf16_(out.dec)
    return out


def build_synthesizer(cfg: RVCConfig, sr: Optional[int] = None, *,
                      training: bool = False) -> Synthesizer:
    """The config's Synthesizer; training=True adds enc_q and the training
    forward."""
    return Synthesizer(cfg.model, sr or cfg.data.sample_rate, training=training,
                       spec_channels=cfg.data.spec_channels,
                       segment_frames=cfg.segment_frames)
