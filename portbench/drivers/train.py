"""GAN training steps through `rvc_tpu_torch.train.train_step.TrainStep`,
back to back, on a seeded pool of batches made on the card in set-up.

Traffic keys: `batch`, `frames` (rows padded to it), `short_share` (the
share of rows cut short, their lengths a fixed set of quantiles over
`short_frames`), `pool` (batches, cycled), `voice` (the rows' waveforms),
`sid`, `check_steps` (the steps the reference follows: the set-up's
first ones, through the window's own call, on batches that all differ).

Besides, every window step whose G or D loss is not finite counts as
failed, and after the window one more step through the same call, from
the state the window left, is held against the reference's losses from
that state (the reference can only follow the program there from the
program's own state; the set-up's steps check the start from the seed).

A row: a seeded voice at the model's rate and its f0 per frame, the
linear spectrogram of the waveform, 768-wide features N(0, 1) (random:
no HuBERT runs in a training step), zero past the row's length. The
draws of each batch (the posterior's eps, the segment starts, the source
noise) are made with it and handed to the step, so the reference gets
the same.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import signals, work
from portbench.drivers import common
from portbench.reference import dsp
from portbench.reference import nets
from portbench.reference import train as RT

KINDS = ("synthesizer", "discriminator")


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.k = 0                  # steps made, set-up's included
        self.steps = 0              # the window's
        self.traced_steps = 0
        self._tracing = False
        self.window_losses: List[tuple] = []      # each window step's (G, D) loss, on the card
        self._failed = None

    # -------------------------------------------------------------- data
    def make_pool(self) -> None:
        t, d = self.traffic, self.config["data"]
        B, T, P = t["batch"], t["frames"], t["pool"]
        hop, sr = d["hop_length"], d["sample_rate"]
        n_short = int(round(t["short_share"] * B * P))
        short = np.linspace(*t["short_frames"], n_short).round().astype(int)
        lens = np.full(B * P, T)
        lens[:n_short] = short
        lens = lens[signals.rng(self.seed, 4).permutation(B * P)]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(self.seed) % (1 << 62) + 17)
        seg = self.config["train"]["segment_size"] // hop
        C = self.config["model"]["inter_channels"]
        self.pool, self.draws = [], []
        for b in range(P):
            rows = lens[b * B:(b + 1) * B]
            wave = torch.zeros(B, T * hop, device=self.device)
            f0 = torch.zeros(B, T, device=self.device)
            for i, n in enumerate(rows):
                y, f = signals.voice(n / 100.0, t["voice"], self.seed * 31 + b * B + i,
                                     self.device, sr=sr, with_f0=True)
                wave[i, : n * hop] = y[: n * hop]
                f0[i, :n] = f[: n * hop: hop][:n]
            lengths = torch.from_numpy(rows).to(self.device)
            valid = (torch.arange(T, device=self.device)[None] < lengths[:, None]).float()
            spec = dsp.spectrogram(wave, d["filter_length"], hop, d["win_length"])[:, :T]
            phone = torch.randn(B, T, 768, generator=gen, device=self.device) * valid[..., None]
            self.pool.append(dict(phone=phone, lengths=lengths, pitch=dsp.coarse_f0(f0),
                                  pitchf=f0, spec=spec * valid[..., None], wave=wave,
                                  sid=torch.full((B,), t["sid"], device=self.device)))
            u = torch.rand(B, generator=gen, device=self.device)
            top = torch.clamp(lengths - seg, min=0)
            self.draws.append(RT.Draws(
                eps=torch.randn(B, T, C, generator=gen, device=self.device),
                ids=torch.minimum((u * (top + 1).float()).long(), top),
                noise=torch.randn(B, seg * hop, generator=gen, device=self.device)))

    # -------------------------------------------------------------- set-up
    def setup(self) -> None:
        from rvc_tpu_torch.configs import config_from_dict
        from rvc_tpu_torch.models.discriminators import build_discriminator
        from rvc_tpu_torch.models.synthesizer import build_synthesizer
        from rvc_tpu_torch.train.train_step import TrainStep, make_optimizers

        common.strict_float32()
        cfg = config_from_dict(self.config)
        states = common.seeded_states(self.config, self.seed, self.device, KINDS, training=True)
        with torch.device(self.device):
            self.net_g = build_synthesizer(cfg, training=True)
            self.net_d = build_discriminator(cfg)
        self.net_g.load_state_dict(states["synthesizer"])
        self.net_d.load_state_dict(states["discriminator"])
        g_opt, d_opt = make_optimizers(cfg, self.net_g, self.net_d)
        self.step = TrainStep(cfg, self.net_g, self.net_d, g_opt, d_opt)
        self.make_pool()
        # the first steps, through the window's own call, read for the check
        b2 = self.config["train"]["betas"][1]
        self.losses: List[Dict[str, float]] = []
        for k in range(self.traffic["check_steps"]):
            out = self._step()
            self.losses.append({n: float(out[n]) for n in ("loss_g_total", "loss_d")})
            if k == 0:
                self.first = {}
                for net, opt in ((self.net_g, g_opt), (self.net_d, d_opt)):
                    names = [n for n, _ in net.named_parameters()]
                    self.first.update(RT.first_grad_norms(opt.nu, names, b2))
        self.change = {}
        for kind, net in zip(KINDS, (self.net_g, self.net_d)):
            for n, p in net.named_parameters():
                self.change[n] = float((p.detach() - states[kind][n]).norm())
        del states

    # -------------------------------------------------------------- window
    def _step(self):
        i = self.k % len(self.pool)
        d = self.draws[i]
        self.k += 1
        return self.step(_batch(self.pool[i]), eps=d.eps, ids_slice=d.ids,
                         source_noise=d.noise[:, :, None])

    def unit(self) -> None:
        out = self._step()
        self.window_losses.append((out["loss_g_total"], out["loss_d"]))
        self.steps += 1
        if self._tracing:
            self.traced_steps += 1

    def finish(self) -> None:
        common.sync(self.device)

    def end_to_end(self, elapsed: float, units: int) -> float:
        """ms a step over the window."""
        return 1e3 * elapsed / units

    def counts(self) -> Tuple[int, int]:
        """The window's steps, and those whose G or D loss is not finite."""
        if self._failed is None:
            losses = torch.stack([torch.stack([g, d]).float() for g, d in self.window_losses])
            self._failed = int((~torch.isfinite(losses)).any(dim=1).sum())
        return self.steps, self._failed

    # -------------------------------------------------------------- tracing
    def roots(self) -> Dict[str, object]:
        """The objects a reader's `WRAP` may name."""
        return {"step": self.step}

    def annotate(self, on: bool) -> None:
        self._tracing = on

    def snapshot(self) -> common.Snapshot:
        return common.Snapshot(work=self.traced_steps)

    def layer_context(self, trace, snap: common.Snapshot) -> common.Layer:
        snap.flop = snap.work * step_flop(self.config, self.traffic)
        return common.Layer(trace=trace, snap=snap)

    # -------------------------------------------------------------- check
    def release(self) -> None:
        """Before the program is freed: its weights as the window left them,
        and one more step through the window's call from there, on the next
        batch of the pool (its losses are held against the reference's from
        the same weights)."""
        self.counts()
        self.late_state = {n: p.detach().clone() for net in (self.net_g, self.net_d)
                           for n, p in net.named_parameters()}
        self.late_index = self.k % len(self.pool)
        out = self._step()
        self.late = {n: float(out[n]) for n in ("loss_g_total", "loss_d")}
        self.window_losses = []
        self.step = self.net_g = self.net_d = None

    def check(self, limits: dict) -> Dict[str, dict]:
        """The reference follows the set-up's first steps from the same
        weights, batches and draws; compared: each step's G and D loss, each
        leaf's first (clipped) gradient norm and each leaf's change over the
        steps, by the widest gap relative to the reference's norm of that
        leaf or of the median leaf, whichever is larger (leaves whose
        reference gradient is under a thousandth of the median leaf's are
        left out of both norms' comparisons)."""
        self.ref = reference_run(self.config, self.seed, self.device, self.pool, self.draws,
                                 self.traffic["check_steps"], self.late_state, self.late_index)
        return compare(self.losses, self.first, self.change, self.late, self.ref, limits)

    def control(self, limits: dict, half_batch: bool = False) -> Dict[str, dict]:
        """The check's numbers of the reference itself, under the precision
        policy in force (`nets.policy`), against the float32 reference; with
        half_batch, of the reference on the first half of every batch (the
        mean over the rest)."""
        pool, draws = self.pool, self.draws
        if half_batch:
            h = self.traffic["batch"] // 2
            pool = [{k: v[:h] for k, v in b.items()} for b in pool]
            draws = [RT.Draws(*(t[:h] for t in d)) for d in draws]
        other = reference_run(self.config, self.seed, self.device, pool, draws,
                              self.traffic["check_steps"], self.late_state, self.late_index)
        return compare([dict(x) for x in other["losses"]], other["first"], other["change"],
                       other["late"], self.ref, limits)


def _batch(b: dict):
    from rvc_tpu_torch.train.train_step import Batch

    return Batch(b["phone"], b["lengths"], b["pitch"], b["pitchf"], b["spec"], b["lengths"],
                 b["wave"], b["sid"])


def reference_run(config: dict, seed: int, device, pool, draws, steps: int,
                  late_state: Dict[str, torch.Tensor], late_index: int) -> dict:
    """The reference's losses, first gradient norms and changes over `steps`
    from the seed's weights; then its losses (`late`) on batch `late_index`
    from the weights `late_state`."""
    common.strict_float32()
    n = common.reference_nets(config, seed, device, KINDS, training=True)
    g, d = n["synthesizer"], n["discriminator"]
    g.requires_grad_(True)
    d.requires_grad_(True)
    start = {k: v.detach().clone() for k, v in list(g.named_parameters())
             + list(d.named_parameters())}
    step = RT.Step(config, g, d)
    losses, first = [], {}
    for k in range(steps):
        losses.append(step(pool[k % len(pool)], draws[k % len(draws)]))
        if k == 0:
            for net, opt in ((g, step.g_opt), (d, step.d_opt)):
                first.update({m: float(c.norm()) for (m, _), c in
                              zip(net.named_parameters(), opt.last_clipped)})
    change = {k: float((p.detach() - start[k]).norm())
              for k, p in list(g.named_parameters()) + list(d.named_parameters())}
    with torch.no_grad():
        for k, p in list(g.named_parameters()) + list(d.named_parameters()):
            p.copy_(late_state[k])
    late = step.losses(pool[late_index], draws[late_index])
    return dict(losses=losses, first=first, change=change, late=late)


def loss_gap(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    """The wider of the G and D losses' relative gaps (inf where the
    program's is not finite)."""
    return max(abs(prog[k] - r) / max(abs(r), 1e-12) if np.isfinite(prog[k]) else float("inf")
               for k, r in ref.items())


def compare(losses, first, change, late, ref: dict, limits: dict) -> Dict[str, dict]:
    loss_rel = max(loss_gap(p, r) for p, r in zip(losses, ref["losses"]))
    med = float(np.median(list(ref["first"].values())))
    leaves = [k for k, v in ref["first"].items() if v >= 1e-3 * med]

    def gap(prog, refd):
        scale = max(float(np.median([refd[k] for k in leaves])), 1e-30)
        return max(abs(prog[k] - refd[k]) / max(refd[k], scale) for k in leaves)

    return {"loss_rel_max": common.verdict(loss_rel, limits["loss_rel_max"]),
            "late_loss_rel": common.verdict(loss_gap(late, ref["late"]),
                                            limits["late_loss_rel"]),
            "first_grad_gap_max": common.verdict(gap(first, ref["first"]),
                                                 limits["first_grad_gap_max"]),
            "change_gap_max": common.verdict(gap(change, ref["change"]),
                                             limits["change_gap_max"])}


_STEP_FLOP: Dict[tuple, float] = {}


def step_flop(config: dict, traffic: dict) -> float:
    """Model FLOP of one G and one D update: the reference step's forward
    and backward passes counted on meta tensors."""
    key = (config["data"]["sample_rate"], traffic["batch"], traffic["frames"])
    if key in _STEP_FLOP:
        return _STEP_FLOP[key]
    B, T = traffic["batch"], traffic["frames"]
    hop = config["data"]["hop_length"]
    seg = config["train"]["segment_size"] // hop
    with torch.device("meta"):
        g = nets.build("synthesizer", config, training=True)
        d = nets.build("discriminator")
        batch = dict(phone=torch.zeros(B, T, 768), lengths=torch.full((B,), T),
                     pitch=torch.ones(B, T, dtype=torch.long), pitchf=torch.ones(B, T),
                     spec=torch.zeros(B, T, config["data"]["filter_length"] // 2 + 1),
                     wave=torch.zeros(B, T * hop), sid=torch.zeros(B, dtype=torch.long))
        draws = RT.Draws(torch.zeros(B, T, config["model"]["inter_channels"]),
                         torch.zeros(B, dtype=torch.long), torch.zeros(B, seg * hop))
        step = RT.Step(config, g, d)

        def one():
            total, y_hat, real = step.g_loss(batch, draws)
            torch.autograd.grad(total, step.g_params, allow_unused=True)
            reals, fakes, _, _ = d(real.detach(), y_hat.detach())
            loss_d = sum(((1 - r) ** 2).mean() + (f ** 2).mean() for r, f in zip(reals, fakes))
            torch.autograd.grad(loss_d, step.d_params)

        _STEP_FLOP[key] = float(work.counted_flop(one))
    return _STEP_FLOP[key]
