"""The GAN train step (counterpart of `rvc_tpu/train/train_step.py`).

Per batch, as the reference's `make_train_step`: the generator's training
forward (prior, posterior, flow, a random segment, the decoder), mel L1
x c_mel (RefineGAN: the multi-scale mel x c_mel / 3) + KL x c_kl +
LS-GAN adversarial + feature matching (no adversarial terms in warmup);
the gradients sanitized (nan/inf -> 0 / +-1e3), `freeze_encoder` zeroing
enc_p's, the generator's `AdamW`; then `d_step_per_g_step` discriminator
updates on the detached segment, each skipped whole while its loss is
under `d_loss_threshold` (decided on the device). The reference runs it
as one jitted program; here it runs eagerly, with K1-K3 under autograd
(`ops/kernels`) and no read-back to the host inside the step.

With RVC_TPU_TRACE=1 a step is the span train/step (its request id the
step's number) over train/g_forward, train/g_backward, G's optim/adamw and
one train/d_update (with D's optim/adamw) per D update.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from rvc_tpu_torch.configs import RVCConfig
from rvc_tpu_torch.ops.commons import slice_segments
from rvc_tpu_torch.ops.stft import mel_spectrogram
from rvc_tpu_torch.train import losses as L
from rvc_tpu_torch.train.optim import AdamW, sanitize_grads
from rvc_tpu_torch.utils.profiling import trace_span

METRICS = ("loss_g_total", "loss_d", "loss_mel", "loss_kl", "loss_adv", "loss_fm",
           "grad_norm_g")


class Batch(NamedTuple):
    phone: torch.Tensor          # (B, T, 768)
    phone_lengths: torch.Tensor  # (B,)
    pitch: torch.Tensor          # (B, T) coarse, int
    pitchf: torch.Tensor         # (B, T) f0
    spec: torch.Tensor           # (B, T, spec_channels)
    spec_lengths: torch.Tensor   # (B,)
    wave: torch.Tensor           # (B, T * hop)
    sid: torch.Tensor            # (B,)

    def to(self, device, non_blocking: bool = False) -> "Batch":
        return Batch(*(t.to(device, non_blocking=non_blocking) for t in self))


def make_optimizers(cfg: RVCConfig, net_g: nn.Module, net_d: nn.Module,
                    steps_per_epoch: int = 100,
                    optimizer: Callable[..., AdamW] = AdamW) -> Tuple[AdamW, AdamW]:
    """(G's AdamW, D's AdamW) as the reference's `make_optimizers`: D's
    learning rate times d_lr_scale; bf16 first moments with use_bf16.
    `optimizer` builds each (`parallel.train.ShardedAdamW` for ZeRO-1)."""
    t = cfg.train
    mu_dtype = torch.bfloat16 if t.use_bf16 else None
    kw = dict(steps_per_epoch=steps_per_epoch, decay_rate=t.lr_decay, b1=t.betas[0],
              b2=t.betas[1], eps=t.eps, mu_dtype=mu_dtype)
    return (optimizer(list(net_g.parameters()), t.learning_rate, **kw),
            optimizer(list(net_d.parameters()), t.learning_rate * t.d_lr_scale, **kw))


class TrainStep:
    """`step(batch, generator)` -> the seven metrics as 0-dim device
    tensors; updates net_g, net_d and both optimizers in place.

    eps / ids_slice / source_noise hand the generator's draws in (the
    tests hand the reference's across); without them they come from
    `generator`."""

    steps = 0       # steps made: the next step's request id

    def __init__(self, cfg: RVCConfig, net_g: nn.Module, net_d: nn.Module,
                 g_opt: AdamW, d_opt: AdamW, adversarial: bool = True,
                 freeze_encoder: bool = False):
        self.cfg, self.net_g, self.net_d = cfg, net_g, net_d
        self.g_opt, self.d_opt = g_opt, d_opt
        self.adversarial = adversarial
        names = [n for n, _ in net_g.named_parameters()]
        self.enc_p = [n.startswith("enc_p.") for n in names] if freeze_encoder else None
        self.multiscale_mel = cfg.model.vocoder == "RefineGAN"

    def _mel(self, wave: torch.Tensor) -> torch.Tensor:
        d = self.cfg.data
        return mel_spectrogram(wave, d.filter_length, d.n_mel_channels, d.sample_rate,
                               d.hop_length, d.win_length, d.mel_fmin, d.mel_fmax)

    def g_losses(self, batch: Batch, generator: Optional[torch.Generator] = None, **draws
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
        """(total, the four losses, y_hat, wave_real) of the generator."""
        cfg = self.cfg
        hop = cfg.data.hop_length
        out = self.net_g(batch.phone, batch.phone_lengths, batch.pitch, batch.pitchf,
                         batch.spec, batch.spec_lengths, batch.sid, generator=generator,
                         **draws)
        y_hat = out.wave
        wave_real = slice_segments(batch.wave, out.ids_slice * hop,
                                   cfg.segment_frames * hop)[:, :, None]
        if self.multiscale_mel:
            loss_mel = L.multi_scale_mel_loss(wave_real[:, :, 0], y_hat[:, :, 0],
                                              cfg.data.sample_rate) * cfg.train.c_mel / 3.0
        else:
            loss_mel = L.mel_l1_loss(self._mel(wave_real[:, :, 0]),
                                     self._mel(y_hat[:, :, 0])) * cfg.train.c_mel
        loss_kl = L.kl_loss(out.z_p, out.logs_q, out.m_p, out.logs_p, out.y_mask,
                            denominator=self.kl_denominator(out.y_mask)) * cfg.train.c_kl
        zero = torch.zeros((), device=y_hat.device)
        loss_adv = loss_fm = zero
        if self.adversarial:
            _, y_d_gs, fmap_rs, fmap_gs = self.net_d(wave_real, y_hat)
            loss_adv = L.generator_loss(y_d_gs)
            loss_fm = L.feature_loss(fmap_rs, fmap_gs)
        total = loss_mel + loss_kl + loss_adv + loss_fm
        return total, dict(loss_mel=loss_mel, loss_kl=loss_kl, loss_adv=loss_adv,
                           loss_fm=loss_fm), y_hat, wave_real

    # the mesh's step (`parallel/train.py`) makes these three global
    def kl_denominator(self, y_mask: torch.Tensor) -> Optional[torch.Tensor]:
        """The KL's normaliser; None: this batch's mask sum."""
        return None

    def reduce_grads(self, grads: List[torch.Tensor],
                     params: List[torch.Tensor]) -> List[torch.Tensor]:
        """The gradients of the whole batch from this step's own (one for
        each of `params`)."""
        return grads

    def reduce_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The whole batch's value of a detached loss."""
        return loss

    def d_loss(self, wave_real: torch.Tensor, y_hat: torch.Tensor) -> torch.Tensor:
        y_d_rs, y_d_gs, _, _ = self.net_d(wave_real, y_hat)
        return L.discriminator_loss(y_d_rs, y_d_gs)

    def g_grads(self, total: torch.Tensor) -> List[torch.Tensor]:
        """G's sanitized gradients of `total`, enc_p's zeroed under
        freeze_encoder (zeros for a parameter the loss does not reach)."""
        params = self.g_opt.params
        grads = torch.autograd.grad(total, params, allow_unused=True)
        grads = sanitize_grads(self.reduce_grads([torch.zeros_like(p) if g is None else g
                                                  for g, p in zip(grads, params)], params))
        if self.enc_p is not None:
            grads = [torch.zeros_like(g) if frozen else g
                     for g, frozen in zip(grads, self.enc_p)]
        return grads

    def d_update(self, wave_real: torch.Tensor, y_hat: torch.Tensor) -> torch.Tensor:
        """One D update on detached segments; returns its loss (before it)."""
        with trace_span("train/d_update"):
            params = self.d_opt.params
            loss = self.d_loss(wave_real, y_hat)
            grads = sanitize_grads(self.reduce_grads(list(torch.autograd.grad(loss, params)),
                                                     params))
            loss = self.reduce_loss(loss.detach())
            threshold = self.cfg.train.d_loss_threshold
            self.d_opt.step(grads, gate=loss >= threshold if threshold > 0 else None)
        return loss

    def __call__(self, batch: Batch, generator: Optional[torch.Generator] = None,
                 **draws) -> Dict[str, torch.Tensor]:
        with trace_span("train/step", request=self.steps):
            self.steps += 1
            self.net_d.requires_grad_(False)      # G's loss takes no D gradient
            try:
                with trace_span("train/g_forward"):
                    total, losses, y_hat, wave_real = self.g_losses(batch, generator, **draws)
                with trace_span("train/g_backward"):
                    grads = self.g_grads(total)
            finally:
                self.net_d.requires_grad_(True)
            self.g_opt.step(grads)
            y_hat, wave_real = y_hat.detach(), wave_real.detach()
            for _ in range(max(self.cfg.train.d_step_per_g_step, 1)):
                loss_d = self.d_update(wave_real, y_hat)
            return dict(loss_g_total=total.detach(), loss_d=loss_d,
                        **{k: v.detach() for k, v in losses.items()},
                        grad_norm_g=self.g_opt.norm(grads))
