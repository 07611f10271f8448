"""Live voice-changer streams through
`rvc_tpu_torch.realtime.pool.VoiceChangerPool.process`, in an open loop:
every `block` of 48 kHz audio (512 ms at read_chunk_size 192) a step of N
blocks, one a stream, is due, whether or not the last step has returned.

A block's latency runs from when it was due (its last sample arrived) to
when the pool returned it; a step's N blocks share one. Traffic keys:
`streams` (N), `read_chunk_size`, `crossfade_s`, `extra_s`, `gate_db`
(the pool's silent_threshold), `index_rate`, `protect`, `sids` (cycled
over the streams), `voice`, `clip_s` (each stream loops a seeded clip of
this length), `warmup_steps` (steps of a separate pool in set-up),
`check_streams` (streams the check follows through the whole window).
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import signals, work
from portbench.drivers import common
from portbench.drivers.song import reference_models
from portbench.reference import nets
from portbench.reference import offline as R
from portbench.reference import stream as RS

# the configuration's serving precision, emulated in the reference
BF16 = dict(content="bf16", prior="bf16", dec="bf16")


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        t = traffic
        self.n = t["streams"]
        self.block = t["read_chunk_size"] * 128
        self.period = self.block / RS.AUDIO_SR
        self.sids = [t["sids"][i % len(t["sids"])] for i in range(self.n)]
        self.latency: List[float] = []           # one a step, seconds
        self.step_s: List[float] = []
        self.failed = 0
        self.traced_steps = 0
        self._tracing = False

    def _pool(self):
        from rvc_tpu_torch.realtime.pool import VoiceChangerPool

        t = self.traffic
        return VoiceChangerPool(self.rvc, self.n, read_chunk_size=t["read_chunk_size"],
                                cross_fade_overlap_size=t["crossfade_s"],
                                extra_convert_size=t["extra_s"], sids=self.sids,
                                silent_threshold=t["gate_db"])

    def setup(self) -> None:
        from rvc_tpu_torch.api import RVC
        from rvc_tpu_torch.configs import config_from_dict

        common.strict_float32()
        t = self.traffic
        states = common.seeded_states(self.config, self.seed, self.device)
        self.rvc = RVC(config=config_from_dict(self.config),
                       synthesizer_state=states["synthesizer"], hubert_state=states["hubert"],
                       rmvpe_state=states["rmvpe"], device=self.device)
        del states
        self.clips = np.stack(signals.voices([t["clip_s"]] * self.n, t["voice"], self.seed,
                                             self.device, sr=RS.AUDIO_SR))
        warm = self._pool()
        for k in range(t["warmup_steps"]):
            warm.process(self.blocks(k + 1000), t.get("pitch_shift", 0.0), t["protect"],
                         t["index_rate"])
        self.pool = self._pool()
        self.check_rows = sorted(int(i) for i in signals.rng(self.seed, 5).choice(
            self.n, min(t["check_streams"], self.n), replace=False))
        self.pre: List[np.ndarray] = []
        self.sola_before: List[np.ndarray] = []
        self.outs: List[np.ndarray] = []
        orig = self.pool._convert

        def keep(*a, **k):       # the pool's audio before SOLA, for the check
            out = orig(*a, **k)
            self.pre.append(out[self.check_rows].copy())
            return out

        self.pool._convert = keep
        self.k = 0
        self.t0 = None

    def blocks(self, k: int) -> np.ndarray:
        """Step k's block of every stream: its clip, looped."""
        idx = (k * self.block + np.arange(self.block)) % self.clips.shape[1]
        return self.clips[:, idx]

    # -------------------------------------------------------------- window
    def unit(self) -> None:
        t = self.traffic
        now = time.perf_counter()
        if self.t0 is None:
            self.t0 = now
        due = self.t0 + (self.k + 1) * self.period      # the step's last sample arrived
        if now < due:
            time.sleep(due - now)
        start = time.perf_counter()
        self.sola_before.append(self.pool.sola_buffer[self.check_rows].copy())
        out, _ = self.pool.process(self.blocks(self.k), t.get("pitch_shift", 0.0),
                                   t["protect"], t["index_rate"])
        end = time.perf_counter()
        self.outs.append(out[self.check_rows].copy())
        self.latency.append(end - due)
        self.step_s.append(end - start)
        self.failed += int((~np.isfinite(out)).any(axis=1).sum())
        if self._tracing:
            self.traced_steps += 1
        self.k += 1

    def finish(self) -> None:
        common.sync(self.device)

    def end_to_end(self, elapsed: float, units: int) -> float:
        """The 95th percentile of every block's latency, ms."""
        return 1e3 * float(np.percentile(self.latency, 95))

    def counts(self) -> Tuple[int, int]:
        return self.n * self.k, self.failed

    # -------------------------------------------------------------- tracing
    def roots(self) -> Dict[str, object]:
        """The objects a reader's `WRAP` may name."""
        return {"pipeline": self.rvc.pipeline, "pool": self.pool}

    def annotate(self, on: bool) -> None:
        self._tracing = on

    def snapshot(self) -> common.Snapshot:
        return common.Snapshot(work=self.traced_steps,
                               spans={"pool/process": 1e3 * float(np.median(self.step_s))})

    def layer_context(self, trace, snap: common.Snapshot) -> common.Layer:
        snap.flop = snap.work * self.n * block_flop(self.config, self.pool)
        return common.Layer(trace=trace, snap=snap)

    # -------------------------------------------------------------- check
    def release(self) -> None:
        g = self.pool
        self.fades = (g.fade_in, g.fade_out, g.sola_search_frame)
        self.pool = self.rvc = None

    def _reference(self):
        """The reference's audio before SOLA of the checked streams, every
        step, (steps, streams, samples), and their gate volumes (steps,
        streams)."""
        t = self.traffic
        m = reference_models(self.config, self.seed, self.device)
        ref = RS.Streams(m, self.check_rows, self.n, [self.sids[i] for i in self.check_rows],
                         self.block, t["crossfade_s"], t["extra_s"], t["gate_db"])
        steps = [ref.convert_step(self.blocks(k)[self.check_rows]) for k in range(len(self.pre))]
        return np.stack([a for a, _ in steps]), np.stack([v for _, v in steps])

    def check(self, limits: dict) -> Dict[str, dict]:
        """The checked streams through the whole window: the relative L2
        distance of their converted audio (every block, before SOLA, all
        streams together) from the float32 reference's, in units of the
        same distance of the reference computed with bf16 products (the
        configuration's serving precision: a sound program reads about 1,
        and the model's own sensitivity, which moves both from seed to
        seed, cancels); and SOLA and the gate redone by the reference
        from the program's own state at each step (its audio before SOLA and
        its previous tail) against the blocks the pool returned."""
        self.ref, vols = self._reference()
        with nets.policy(**BF16):
            self.ref_bf16, _ = self._reference()
        pre = np.stack(self.pre)
        rows = range(len(self.check_rows))
        fade_in, fade_out, search = self.fades
        gate = 10 ** (self.traffic["gate_db"] / 20)
        sola = 0.0
        for k in range(len(self.pre)):
            for i in rows:
                got = RS.sola_crossfade(pre[k, i], self.sola_before[k][i].copy(), fade_in,
                                        fade_out, self.block, search)
                want = np.zeros_like(got) if vols[k, i] < gate else got
                sola = max(sola, float(np.abs(want - self.outs[k][i]).max()))
        return {"block_rel_l2_vs_bf16": common.verdict(self._vs_bf16(pre),
                                                       limits["block_rel_l2_vs_bf16"]),
                "sola_max_abs": common.verdict(sola, limits["sola_max_abs"])}

    def _vs_bf16(self, audio: np.ndarray) -> float:
        """audio's relative L2 distance from the float32 reference, over the
        reference's own in the configuration's precision (bf16 products)."""
        return common.rel_l2(audio, self.ref) / common.rel_l2(self.ref_bf16, self.ref)

    def control(self, limits: dict) -> Dict[str, dict]:
        """The check's block number of the reference itself, under the
        precision policy in force (`nets.policy`)."""
        other, _ = self._reference()
        return {"block_rel_l2_vs_bf16": common.verdict(self._vs_bf16(other),
                                                       limits["block_rel_l2_vs_bf16"])}


_BLOCK_FLOP: Dict[tuple, float] = {}


def block_flop(config: dict, pool) -> float:
    """Model FLOP of one stream's block program: the f0 program on the
    buffer's tail, HuBERT on the padded buffer, the synthesizer over its
    frames, counted on the plain reference on meta tensors."""
    from portbench.reference import nets

    g = RS.geometry(pool.block_frame, pool.crossfade_frame, pool.sola_search_frame,
                    pool.extra_frame)
    b = R.BUCKET * R.WIN
    n = -(-g.size // b) * b
    key = (config["data"]["sample_rate"], n)
    if key not in _BLOCK_FLOP:
        with torch.device("meta"):
            h, r, s = (nets.build(k, config) for k in ("hubert", "rmvpe", "synthesizer"))
            tail = g.size - g.silence_front * R.WIN
            f32 = 32 * ((tail // R.WIN) // 32 + 1)
            t = 2 * (n // 320 - 1)
            flop = work.counted_flop(h, torch.zeros(1, n))
            flop += work.counted_flop(r.trunk, torch.zeros(1, f32, 128))
            flop += work.gru_flop(1, f32, 384, 256) + 2 * f32 * 512 * 360
            flop += work.counted_flop(
                s.infer, torch.zeros(1, t, 768), torch.full((1,), g.frames, dtype=torch.long),
                torch.ones(1, t, dtype=torch.long), torch.ones(1, t),
                torch.zeros(1, dtype=torch.long), torch.zeros(1, t * s.dec.upp))
        _BLOCK_FLOP[key] = float(flop)
    return _BLOCK_FLOP[key]
