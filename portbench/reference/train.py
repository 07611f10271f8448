"""The plain reference of one RVC v2 GAN training step, in float32.

The generator's loss (VITS / RVC v2): the posterior encoder on the linear
spectrogram, the flow into prior space, a segment of the posterior decoded
by the NSF HiFi-GAN; mel L1 x c_mel + KL x c_kl + the LS-GAN adversarial
loss + 2 x feature matching against the multi-period discriminator. The
gradients are sanitized (nan -> 0, +-inf and beyond -> +-1e3) and applied
by optax's chain clip_by_global_norm(1) -> adamw(lr, b1, b2, eps, 0.01),
the first moment stored in bf16 when the configuration says so. Then one
discriminator step on the detached segment, LS-GAN, the same chain. The
random draws (the posterior's eps, the segment starts, the source noise)
are handed in.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import torch

from portbench.reference import dsp


class Draws(NamedTuple):
    eps: torch.Tensor          # (B, T, inter)
    ids: torch.Tensor          # (B,) segment starts in frames
    noise: torch.Tensor        # (B, segment samples) source noise


def slice_rows(x: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """Per-row time slice of (B, C, T) or (B, T) from each row's start."""
    idx = ids.long()[:, None] + torch.arange(n, device=x.device)
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(x, 2, idx[:, None, :].expand(-1, x.shape[1], -1))


class AdamW:
    """clip_by_global_norm(1.0) -> Adam (b1, b2, eps) -> + 0.01 p -> x -lr
    with lr = lr0 * decay ** floor(count / steps_per_epoch)."""

    def __init__(self, params: List[torch.Tensor], lr: float, b1: float, b2: float, eps: float,
                 decay: float, steps_per_epoch: int = 100, mu_dtype=None):
        self.params, self.lr, self.b1, self.b2, self.eps = params, lr, b1, b2, eps
        self.decay, self.spe = decay, steps_per_epoch
        self.mu = [torch.zeros_like(p, dtype=mu_dtype or p.dtype) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0
        self.last_clipped: List[torch.Tensor] = []

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        grads = [torch.where(norm < 1.0, g, g / norm) for g in grads]
        self.last_clipped = grads
        lr = self.lr * self.decay ** (self.count // self.spe)
        self.count += 1
        bc1, bc2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        for p, g, i in zip(self.params, grads, range(len(grads))):
            m = (1 - self.b1) * g + self.b1 * self.mu[i].float()
            v = (1 - self.b2) * g * g + self.b2 * self.nu[i]
            p -= lr * ((m / bc1) / (torch.sqrt(v / bc2) + self.eps) + 0.01 * p)
            self.mu[i] = m.to(self.mu[i].dtype)
            self.nu[i] = v


def sanitize(grads: List[torch.Tensor]) -> List[torch.Tensor]:
    return [torch.clamp(torch.nan_to_num(g, nan=0.0, posinf=1e3, neginf=-1e3), -1e3, 1e3)
            for g in grads]


class Step:
    """One G update and one D update of the reference networks `g` (a
    training `nets.Synthesizer`) and `d` (`nets.MultiPeriodDiscriminator`)."""

    def __init__(self, config: dict, g, d):
        self.cfg, self.g, self.d = config, g, d
        t = config["train"]
        mu = torch.bfloat16 if t["use_bf16"] else None
        kw = dict(b1=t["betas"][0], b2=t["betas"][1], eps=t["eps"], decay=t["lr_decay"],
                  mu_dtype=mu)
        self.g_params = [p for _, p in g.named_parameters()]
        self.d_params = [p for _, p in d.named_parameters()]
        self.g_opt = AdamW(self.g_params, t["learning_rate"], **kw)
        self.d_opt = AdamW(self.d_params, t["learning_rate"] * t["d_lr_scale"], **kw)

    def _mel(self, wave):
        dd = self.cfg["data"]
        return dsp.mel_spectrogram(wave, dd["filter_length"], dd["n_mel_channels"],
                                   dd["sample_rate"], dd["hop_length"], dd["win_length"],
                                   dd["mel_fmin"], dd["mel_fmax"])

    def g_loss(self, batch: Dict[str, torch.Tensor], draws: Draws):
        """(total, y_hat, the real segment) of the generator."""
        g, cfg = self.g, self.cfg
        hop = cfg["data"]["hop_length"]
        seg = cfg["train"]["segment_size"] // hop
        gin = g.emb_g(batch["sid"])[:, :, None]
        m_p, logs_p, _ = g.enc_p(batch["phone"], batch["pitch"], batch["lengths"])
        z, m_q, logs_q, y_mask = g.enc_q(batch["spec"], batch["lengths"], gin, draws.eps)
        z_p = g.flow(z, y_mask, gin, reverse=False)
        y_hat = g.dec(slice_rows(z, draws.ids, seg), slice_rows(batch["pitchf"], draws.ids, seg),
                      gin, draws.noise)
        real = slice_rows(batch["wave"], draws.ids * hop, seg * hop)
        loss_mel = (self._mel(real) - self._mel(y_hat)).abs().mean() * cfg["train"]["c_mel"]
        lp, lq = logs_p.clamp(-10, 10), logs_q.clamp(-10, 10)
        kl = lp - lq - 0.5 + 0.5 * (z_p - m_p) ** 2 * torch.exp(-2.0 * lp)
        loss_kl = (kl * y_mask).sum() / y_mask.sum().clamp(min=1.0) * cfg["train"]["c_kl"]
        _, fakes, fmap_r, fmap_g = self.d(real, y_hat)
        adv = sum(((1 - f) ** 2).mean() for f in fakes)
        fm = 2 * sum((r.detach() - f).abs().mean() for rs, fs in zip(fmap_r, fmap_g)
                     for r, f in zip(rs, fs))
        return loss_mel + loss_kl + adv + fm, y_hat, real

    def __call__(self, batch: Dict[str, torch.Tensor], draws: Draws) -> Dict[str, float]:
        self.d.requires_grad_(False)
        total, y_hat, real = self.g_loss(batch, draws)
        grads = torch.autograd.grad(total, self.g_params, allow_unused=True)
        self.d.requires_grad_(True)
        self.g_opt.step(sanitize([torch.zeros_like(p) if gr is None else gr
                                  for gr, p in zip(grads, self.g_params)]))
        y_hat, real = y_hat.detach(), real.detach()
        reals, fakes, _, _ = self.d(real, y_hat)
        loss_d = sum(((1 - r) ** 2).mean() + (f ** 2).mean() for r, f in zip(reals, fakes))
        self.d_opt.step(sanitize(list(torch.autograd.grad(loss_d, self.d_params))))
        return {"loss_g_total": float(total.detach()), "loss_d": float(loss_d.detach())}


    @torch.no_grad()
    def losses(self, batch: Dict[str, torch.Tensor], draws: Draws) -> Dict[str, float]:
        """The G and D losses a step from the present weights reports,
        with no update."""
        total, y_hat, real = self.g_loss(batch, draws)
        reals, fakes, _, _ = self.d(real, y_hat)
        loss_d = sum(((1 - r) ** 2).mean() + (f ** 2).mean() for r, f in zip(reals, fakes))
        return {"loss_g_total": float(total), "loss_d": float(loss_d)}


def first_grad_norms(nu: List[torch.Tensor], names: List[str], b2: float) -> Dict[str, float]:
    """Each leaf's norm of the first (clipped) gradient, from an optimizer's
    second moment after one step, nu = (1 - b2) g^2."""
    return {n: float(torch.sqrt(v.float().sum() / (1 - b2))) for n, v in zip(names, nu)}
