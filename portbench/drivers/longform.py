"""Batched long-form conversion through
`rvc_tpu_torch.parallel.infer.BatchConverter.convert_long_batch`: jobs of
utterances back to back, one client in a closed loop.

Traffic keys: `lengths` (every utterance of the pool, `signals.lengths`),
`per_job` (utterances a job), `voice`, `sid`, `chunk_s`, `pad_s`,
`batch_size`, `warmup_s`, `check_utterances` (how many finished
utterances the check converts again: the longest and the rest drawn from
the seed).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import signals
from portbench.drivers import common
from portbench.drivers.song import offline_flop, reference_models, sample
from portbench.reference import offline as R


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.done: Dict[int, np.ndarray] = {}      # utterance -> its first output
        self.items = 0
        self.failed = 0
        self.work = 0.0
        self.traced_s = 0.0
        self.traced_windows = 0
        self._tracing = False

    def setup(self) -> None:
        from rvc_tpu_torch.api import RVC
        from rvc_tpu_torch.configs import config_from_dict
        from rvc_tpu_torch.parallel.infer import BatchConverter

        common.strict_float32()
        t = self.traffic
        states = common.seeded_states(self.config, self.seed, self.device)
        self.rvc = RVC(config=config_from_dict(self.config),
                       synthesizer_state=states["synthesizer"], hubert_state=states["hubert"],
                       rmvpe_state=states["rmvpe"], device=self.device)
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

    def _convert(self, utts: List[np.ndarray]) -> List[np.ndarray]:
        t = self.traffic
        return self.bc.convert_long_batch(utts, [t["sid"]] * len(utts), chunk_seconds=t["chunk_s"],
                                          pad_seconds=t["pad_s"], batch_size=t["batch_size"])

    def windows(self, n: int) -> int:
        return max(1, -(-n // int(self.traffic["chunk_s"] * signals.SR)))

    # -------------------------------------------------------------- window
    def unit(self) -> None:
        job = self.jobs[self.next % len(self.jobs)]
        outs = self._convert([self.utts[u] for u in job])
        for u, o in zip(job, outs):
            self.done.setdefault(u, o)
            self.failed += int(not np.all(np.isfinite(o)))
        self.items += len(job)
        seconds = sum(len(self.utts[u]) for u in job) / signals.SR
        self.work += seconds
        if self._tracing:
            self.traced_s += seconds
            self.traced_windows += sum(self.windows(len(self.utts[u])) for u in job)
        self.next += 1

    def finish(self) -> None:
        common.sync(self.device)

    def end_to_end(self, elapsed: float, units: int) -> float:
        """audio-s/s over the window."""
        return self.work / elapsed

    def counts(self) -> Tuple[int, int]:
        return self.items, self.failed

    # -------------------------------------------------------------- tracing
    def roots(self) -> Dict[str, object]:
        """The objects a reader's `WRAP` may name."""
        return {"pipeline": self.rvc.pipeline}

    def annotate(self, on: bool) -> None:
        self._tracing = on

    def snapshot(self) -> common.Snapshot:
        return common.Snapshot(work=self.traced_s)

    def layer_context(self, trace, snap: common.Snapshot) -> common.Layer:
        t = self.traffic
        n = int((t["chunk_s"] + 2 * t["pad_s"]) * signals.SR)
        snap.flop = self.traced_windows * offline_flop(self.config, n)
        return common.Layer(trace=trace, snap=snap)

    # -------------------------------------------------------------- check
    def release(self) -> None:
        self.bc = self.rvc = None

    def check(self, limits: dict) -> Dict[str, dict]:
        """The longest finished utterance and check_utterances - 1 more
        drawn from the seed, converted again by the plain reference (each
        in its own job's window order): the widest relative L2 distance of
        a program output from the reference's."""
        t = self.traffic
        pick = sample(self.done, self.lengths, t["check_utterances"], self.seed)
        self._m = reference_models(self.config, self.seed, self.device)
        self.refs = {u: self._reference(u) for u in pick}
        worst = max(common.rel_l2(self.done[u], r) for u, r in self.refs.items())
        return {"wave_rel_l2_max": common.verdict(worst, limits["wave_rel_l2_max"])}

    def _reference(self, u: int) -> np.ndarray:
        t = self.traffic
        job = next(j for j in self.jobs if u in j)
        with torch.inference_mode():
            return R.convert_long(self._m, [self.utts[v] for v in job], [job.index(u)],
                                  [t["sid"]] * len(job), t["chunk_s"], t["pad_s"],
                                  t["batch_size"])[job.index(u)]

    def control(self, limits: dict) -> Dict[str, dict]:
        """The check's number of the reference itself, under the precision
        policy in force (`nets.policy`), on the items `check` compared."""
        worst = max(common.rel_l2(self._reference(u), r) for u, r in self.refs.items())
        return {"wave_rel_l2_max": common.verdict(worst, limits["wave_rel_l2_max"])}
