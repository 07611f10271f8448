"""Whole songs through `rvc_tpu_torch.api.RVC.infer`, one client in a closed
loop, without retrieval (no cell retrieves yet: PERF.md, Open questions).

Traffic keys: `lengths` (the song lengths, `signals.lengths`), `voice` (the
signal), `protect`, `sid`, `warmup_s`, `check_songs` (how many finished
songs the check converts again: the longest and the rest drawn from the
seed).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import signals, work
from portbench.drivers import common
from portbench.reference import offline as R


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.sr = config["data"]["sample_rate"]
        self.done: Dict[int, np.ndarray] = {}     # song -> its first output in the window
        self.converted: List[int] = []
        self.failed = 0
        self.traced: List[int] = []
        self._tracing = False

    # -------------------------------------------------------------- set-up
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
        self.lengths = signals.lengths(t["lengths"], self.seed)
        self.songs = signals.voices(self.lengths, t["voice"], self.seed, self.device)
        warm = signals.voice(t["warmup_s"], t["voice"], self.seed * 7 + 999, self.device)
        self._convert(warm.cpu().numpy())
        # every padded chunk length the pool will send, once: the libraries
        # plan each new shape on its first call
        for n in sorted({n for song in self.songs for n in padded_chunks(song)}):
            self.rvc.pipeline.convert_chunk(np.resize(self.songs[0], n), t["sid"], 0.0, 0.0,
                                            t["protect"], trim_frames=R.X_PAD * R.SR // R.WIN)
        self.next = 0

    def _convert(self, audio: np.ndarray) -> np.ndarray:
        t = self.traffic
        return self.rvc.infer(audio, sid=t["sid"], index_rate=t["index_rate"],
                              protect=t["protect"])

    # -------------------------------------------------------------- window
    def unit(self) -> None:
        i = self.next % len(self.songs)
        out = self._convert(self.songs[i])
        self.done.setdefault(i, out)
        self.converted.append(i)
        self.failed += int(not np.all(np.isfinite(out)))
        if self._tracing:
            self.traced.append(i)
        self.next += 1

    def finish(self) -> None:
        common.sync(self.device)

    def audio_s(self, items) -> float:
        return float(sum(len(self.songs[i]) for i in items) / signals.SR)

    def end_to_end(self, elapsed: float, units: int) -> float:
        """audio-s/s over the window."""
        return self.audio_s(self.converted) / elapsed

    def counts(self) -> Tuple[int, int]:
        return len(self.converted), self.failed

    # -------------------------------------------------------------- tracing
    def roots(self) -> Dict[str, object]:
        """The objects a reader's `WRAP` may name."""
        return {"pipeline": self.rvc.pipeline}

    def annotate(self, on: bool) -> None:
        from rvc_tpu_torch.utils import profiling

        if on:
            profiling.global_tracer().totals.clear()
            profiling.global_tracer().counts.clear()
        self._tracing = on

    def snapshot(self) -> common.Snapshot:
        from rvc_tpu_torch.utils import profiling

        return common.Snapshot(work=self.audio_s(self.traced),
                               spans=dict(profiling.global_tracer().totals))

    def layer_context(self, trace, snap: common.Snapshot) -> common.Layer:
        snap.flop = sum(self.song_flop(self.songs[i]) for i in self.traced)
        return common.Layer(trace=trace, snap=snap)

    def song_flop(self, audio: np.ndarray) -> float:
        """Model FLOP of converting one song: every chunk's networks at its
        padded length (`offline_flop`)."""
        return sum(offline_flop(self.config, n) for n in padded_chunks(audio))

    # -------------------------------------------------------------- check
    def release(self) -> None:
        self.rvc = None

    def check(self, limits: dict) -> Dict[str, dict]:
        """The longest finished song and check_songs - 1 more drawn from the
        seed, converted again by the plain reference (float32): the widest
        relative L2 distance of a program output from the reference's."""
        done = self.done
        pick = sample(done, self.lengths, self.traffic["check_songs"], self.seed)
        self._m = reference_models(self.config, self.seed, self.device)
        self.refs = {i: self._reference(i) for i in pick}
        worst = max(common.rel_l2(done[i], r) for i, r in self.refs.items())
        return {"wave_rel_l2_max": common.verdict(worst, limits["wave_rel_l2_max"])}

    def _reference(self, i: int) -> np.ndarray:
        with torch.inference_mode():
            return R.convert_song(self._m, self.songs[i], self.traffic["sid"])

    def control(self, limits: dict) -> Dict[str, dict]:
        """The check's number of the reference itself, under the precision
        policy in force (`nets.policy`), on the items `check` compared."""
        worst = max(common.rel_l2(self._reference(i), r)
                    for i, r in self.refs.items())
        return {"wave_rel_l2_max": common.verdict(worst, limits["wave_rel_l2_max"])}


def padded_chunks(audio: np.ndarray) -> List[int]:
    """The padded length in samples of each chunk the pipeline cuts a
    recording into (the reference's chunking: high-pass, split points,
    1 s of context each side, whole buckets)."""
    from portbench.reference import dsp

    b = R.BUCKET * R.WIN
    return [-(-(e - s + 2 * R.SR * R.X_PAD) // b) * b
            for s, e in R.chunk_bounds(dsp.highpass(audio))]


def sample(done: Dict[int, np.ndarray], lengths, n: int, seed: int) -> List[int]:
    """The longest item in `done` and n - 1 more drawn from the seed."""
    keys = sorted(done, key=lambda i: (-lengths[i], i))
    rest = keys[1:]
    rng = signals.rng(seed, 3)
    extra = list(rng.choice(rest, min(n - 1, len(rest)), replace=False)) if rest else []
    return keys[:1] + [int(i) for i in extra]


def reference_models(config: dict, seed: int, device) -> R.Models:
    common.strict_float32()
    n = common.reference_nets(config, seed, device)
    return R.Models(n["hubert"], n["rmvpe"], n["synthesizer"], config["data"]["sample_rate"])


_FLOP_FIT: Dict[tuple, np.ndarray] = {}


def offline_flop(config: dict, n: int, batch: int = 1) -> float:
    """Model FLOP of converting padded 16 kHz audio of n samples (per row,
    times `batch`): HuBERT, RMVPE (its GRU by `work.gru_flop`), the
    synthesizer, counted on the plain reference at three lengths and
    evaluated by the quadratic through them (attention is quadratic in
    length, the rest linear)."""
    key = (config["data"]["sample_rate"],)
    if key not in _FLOP_FIT:
        xs = np.array([1.0, 2.0, 3.0]) * R.BUCKET * R.WIN * 4
        ys = np.array([_count(config, int(x)) for x in xs])
        _FLOP_FIT[key] = np.polyfit(xs, ys, 2)
    return batch * float(np.polyval(_FLOP_FIT[key], n))


def _count(config: dict, n: int) -> float:
    from portbench.reference import nets

    with torch.device("meta"):
        h, r, s = (nets.build(k, config) for k in ("hubert", "rmvpe", "synthesizer"))
        audio = torch.zeros(1, n)
        frames = n // R.WIN
        f32 = 32 * ((frames) // 32 + 1)
        flop = work.counted_flop(h, audio)
        flop += work.counted_flop(r.trunk, torch.zeros(1, f32, 128))
        flop += work.gru_flop(1, f32, 384, 256) + 2 * f32 * 512 * 360
        t = frames
        upp = s.dec.upp
        flop += work.counted_flop(
            s.infer, torch.zeros(1, t, 768), torch.full((1,), t, dtype=torch.long),
            torch.ones(1, t, dtype=torch.long), torch.ones(1, t), torch.zeros(1, dtype=torch.long),
            torch.zeros(1, t * upp))
    return float(flop)
