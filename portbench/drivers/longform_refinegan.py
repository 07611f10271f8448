"""Batched long-form conversion through a RefineGAN voice: the long-form
driver (`drivers.longform`) with the RefineGAN decoder's plain reference
(`reference.refinegan`), its seeded weights (`seeded_synthesizer`) and its
model FLOP (`offline_flop`). The traffic keys are the long-form driver's.

Seeded weights: every tensor as `weights._scale` draws it (convolutions
N(0, 1 / (3 fan_in)), their biases alike, the merge N(0, 1 / 3)), but
AdaIN's weights, N(0, ADAIN_STD), and the ParallelResBlocks' convolutions
(`input_conv` and the ResBlocks'), whose spread is scaled by STAGE_GAIN.
Chosen on the host with the full-width 48 kHz decoder on a 2 s voice, five
seeds: at gain 1 the output is 0.005-0.13 RMS; at 1.75 0.003-0.33, no
sample past 0.9, another speaker id moves the waveform by 17-794% and a
zeroed latent by 15-96% (neither the sine template alone nor saturated);
at 2.25 99.7% of the samples pass 0.9, at 2.5 all. With AdaIN at 0.003 its
noise moves the output by 0.4-7.3% (62% on the seed of 0.003 RMS); at 0.01
by 1.4-91%. A random four-stage U-Net compounds its gains, so the seeds
spread widely.

The check has two numbers. `wave_rel_l2_max` is the long-form driver's:
whole utterances against the reference's conversion, where the bf16
HuBERT and prior dominate the gap. `decoder_rel_l2_max` holds the decoder
alone: the window's first DEC_CALLS calls of the program's decoder are
kept (its latent, f0 and speaker, the noise generator's state on entry,
and its output; copies on the device, no wait; one card holds a dispatch's
rows whole),
and the reference decoder redoes each from the same inputs and the same
noise, in float32 on the parameters rounded through bf16 where the
configuration's serving policy rounds them (on the card): the widest
||program - reference|| / ||reference|| of a call.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from portbench import signals, weights, work
from portbench.drivers import common, longform
from portbench.reference import nets, offline as R, refinegan as RG

ADAIN_STD = 0.003
STAGE_GAIN = 1.75
DEC_CALLS = 4        # the window's first decoder calls the check redoes


def _scale(module: nn.Module, name: str, shape) -> tuple:
    if name.startswith("dec.upsample_conv_blocks.") and name.endswith(".weight"):
        owner = module.get_submodule(name.rsplit(".", 1)[0])
        if isinstance(owner, RG.AdaIN):
            return 0.0, ADAIN_STD
        mean, std = weights._scale(module, name, shape)
        return mean, std * STAGE_GAIN
    return weights._scale(module, name, shape)


def make(module: nn.Module, seed: int, device, stream: int) -> Dict[str, torch.Tensor]:
    """`weights.make` with this decoder's scales: one draw of every float
    tensor of `module`'s state, in order, from (seed, stream)."""
    sd = module.state_dict()
    total = sum(v.numel() for v in sd.values() if v.is_floating_point())
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 7919 + stream) % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for k, v in sd.items():
        if not v.is_floating_point():
            out[k] = torch.zeros_like(v, device=device)
            continue
        mean, std = _scale(module, k, v.shape)
        out[k] = flat[at: at + v.numel()].view(v.shape) * std + mean
        if k.endswith("running_var"):
            out[k] = out[k].abs()
        at += v.numel()
    return out


def seeded_synthesizer(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The RefineGAN synthesizer's state dict of the seed (the stream of
    `common.STREAMS["synthesizer"]`)."""
    with torch.device("meta"):
        shell = RG.build(config)
    return make(shell.to_empty(device=device), seed, device, common.STREAMS["synthesizer"])


def reference_models(config: dict, seed: int, device) -> R.Models:
    """The plain reference's HuBERT, RMVPE and RefineGAN synthesizer with
    the seed's weights."""
    common.strict_float32()
    n = common.reference_nets(config, seed, device, ("hubert", "rmvpe"))
    with torch.device("meta"):
        shell = RG.build(config)
    synth = shell.to_empty(device=device)
    synth.load_state_dict(seeded_synthesizer(config, seed, device))
    synth = synth.eval().requires_grad_(False)
    return R.Models(n["hubert"], n["rmvpe"], synth, config["data"]["sample_rate"])


_FLOP_FIT: Dict[tuple, np.ndarray] = {}


def offline_flop(config: dict, n: int) -> float:
    """Model FLOP of converting a padded 16 kHz window of n samples: HuBERT,
    RMVPE (its GRU by `work.gru_flop`), enc_p, the flow and the RefineGAN
    decoder, counted on the plain reference at three lengths and evaluated
    by the quadratic through them."""
    key = (config["data"]["sample_rate"], config["model"]["upsample_initial_channel"])
    if key not in _FLOP_FIT:
        xs = np.array([1.0, 2.0, 3.0]) * R.BUCKET * R.WIN * 4
        _FLOP_FIT[key] = np.polyfit(xs, [_count(config, int(x)) for x in xs], 2)
    return float(np.polyval(_FLOP_FIT[key], n))


def _count(config: dict, n: int) -> float:
    with torch.device("meta"):
        h, r = (nets.build(k) for k in ("hubert", "rmvpe"))
        s = RG.build(config)
        frames = n // R.WIN
        f32 = 32 * (frames // 32 + 1)
        flop = work.counted_flop(h, torch.zeros(1, n))
        flop += work.counted_flop(r.trunk, torch.zeros(1, f32, 128))
        flop += work.gru_flop(1, f32, 384, 256) + 2 * f32 * 512 * 360
        flop += work.counted_flop(
            s.infer, torch.zeros(1, frames, 768), torch.full((1,), frames, dtype=torch.long),
            torch.ones(1, frames, dtype=torch.long), torch.ones(1, frames),
            torch.zeros(1, dtype=torch.long))
    return float(flop)


class Driver(longform.Driver):
    def setup(self) -> None:
        from rvc_tpu_torch.api import RVC
        from rvc_tpu_torch.configs import config_from_dict
        from rvc_tpu_torch.parallel.infer import BatchConverter

        common.strict_float32()
        t = self.traffic
        states = common.seeded_states(self.config, self.seed, self.device, ("hubert", "rmvpe"))
        self.rvc = RVC(config=config_from_dict(self.config),
                       synthesizer_state=seeded_synthesizer(self.config, self.seed, self.device),
                       hubert_state=states["hubert"], rmvpe_state=states["rmvpe"],
                       device=self.device)
        del states
        self.bc = BatchConverter(self.rvc)
        self.lengths = signals.lengths(t["lengths"], self.seed)
        self.utts = signals.voices(self.lengths, t["voice"], self.seed, self.device)
        k = t["per_job"]
        self.jobs = [list(range(j, j + k)) for j in range(0, len(self.utts), k)]
        warm = [signals.voice(t["warmup_s"], t["voice"], self.seed * 7 + 999 + i,
                              self.device).cpu().numpy() for i in range(k)]
        self._convert(warm)
        self.next = 0
        self._keep_decoder_calls()

    def _keep_decoder_calls(self) -> None:
        """From now on keep the program decoder's first DEC_CALLS calls
        (`check`): a wrap of the decoder instance's forward."""
        from rvc_tpu_torch.utils.device import compute_dtype

        self.dec_calls: List[dict] = []
        self._dec = self.rvc.pipeline.models(compute_dtype(self.device))[1].dec
        inner, calls = self._dec.forward, self.dec_calls

        def forward(mel, f0, g=None, generator=None):
            if len(calls) >= DEC_CALLS:
                return inner(mel, f0, g=g, generator=generator)
            call = dict(mel=mel.clone(), f0=f0.clone(), g=None if g is None else g.clone(),
                        state=None if generator is None else generator.get_state())
            out = inner(mel, f0, g=g, generator=generator)
            calls.append(dict(call, out=out.clone()))
            return out

        self._dec.forward = forward

    def release(self) -> None:
        del self._dec.forward
        self._dec = None
        super().release()

    def layer_context(self, trace, snap: common.Snapshot) -> common.Layer:
        t = self.traffic
        n = int((t["chunk_s"] + 2 * t["pad_s"]) * signals.SR)
        snap.flop = self.traced_windows * offline_flop(self.config, n)
        return common.Layer(trace=trace, snap=snap)

    def check(self, limits: dict) -> Dict[str, dict]:
        """As the long-form driver's, against the RefineGAN reference, and
        the decoder alone on the kept calls (`decoder_rel_l2_max`)."""
        t = self.traffic
        pick = longform.sample(self.done, self.lengths, t["check_utterances"], self.seed)
        self._m = reference_models(self.config, self.seed, self.device)
        self.refs = {u: self._reference(u) for u in pick}
        worst = max(common.rel_l2(self.done[u], r) for u, r in self.refs.items())
        self.dec_refs = self._decoder_outputs()
        dec = max(common.rel_l2(c["out"][..., 0].cpu().numpy(), r)
                  for c, r in zip(self.dec_calls, self.dec_refs))
        return {"wave_rel_l2_max": common.verdict(worst, limits["wave_rel_l2_max"]),
                "decoder_rel_l2_max": common.verdict(dec, limits["decoder_rel_l2_max"])}

    def _decoder_outputs(self) -> List[np.ndarray]:
        """The reference decoder on each kept call's inputs and noise, under
        the precision policy in force (`nets.policy`)."""
        dec = self._m.synth.dec
        if self.device.type == "cuda":     # the serving policy's bf16-rounded parameters
            dec = copy.deepcopy(dec)
            with torch.no_grad():
                for p in dec.parameters():
                    p.copy_(p.to(torch.bfloat16))
        outs = []
        for c in self.dec_calls:
            gen = None
            if c["state"] is not None:
                gen = torch.Generator(device=self.device)
                gen.set_state(c["state"])
            g = None if c["g"] is None else c["g"].float().transpose(1, 2)
            with torch.inference_mode():
                out = dec(c["mel"].float().transpose(1, 2), c["f0"].float(), g, gen)
            outs.append(out.cpu().numpy())
        return outs

    def control(self, limits: dict) -> Dict[str, dict]:
        """The long-form driver's control, and the reference decoder under
        the policy in force against its float32 outputs of `check`."""
        out = super().control(limits)
        dec = max(common.rel_l2(r, want)
                  for r, want in zip(self._decoder_outputs(), self.dec_refs))
        out["decoder_rel_l2_max"] = common.verdict(dec, limits["decoder_rel_l2_max"])
        return out

    def _reference(self, u: int) -> np.ndarray:
        t = self.traffic
        job = next(j for j in self.jobs if u in j)
        with torch.inference_mode():
            return RG.convert_long(self._m, [self.utts[v] for v in job], [job.index(u)],
                                   [t["sid"]] * len(job), t["chunk_s"], t["pad_s"],
                                   t["batch_size"])[job.index(u)]


def stage_work(batch: int, t_in: int, c: int, rate: int, t_skip: Optional[int] = None,
               kernel_sizes=RG.KERNELS, dilations=RG.DILATIONS, elem_bytes: int = 4):
    """(FLOP, bytes) of one RefineGAN stage call from its input's shape
    (B, T, C), its rate and its skip tap's length (default T * rate): the
    convolutions' products at T_out = min(T * rate, skip) (`input_conv`,
    k 7, C + C / 4 -> C / 2; per branch three dilation steps of two
    k-tap convolutions C / 2 -> C / 2), two FLOP a multiply-add, as
    `FlopCounterMode` counts them; bytes: the input and the skip read once,
    every weight and bias once, the output written once."""
    t_out = min(t_in * rate, t_skip if t_skip is not None else t_in * rate)
    cin, co = c + c // 4, c // 2
    taps = sum(2 * len(dilations) * k for k in kernel_sizes)
    flop = 2 * batch * t_out * co * (7 * cin + taps * co)
    wts = 7 * cin * co + co + sum(2 * len(dilations) * (k * co * co + co) for k in kernel_sizes)
    wts += 2 * len(kernel_sizes) * co          # AdaIN's weights
    return flop, elem_bytes * (batch * (t_in * c + t_out * c // 4 + t_out * co) + wts)
