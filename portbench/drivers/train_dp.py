"""Data-parallel GAN training: `ranks` processes, one a card, each stepping
`RVCTrainer(mesh=make_mesh()).step_fn(True)` (`DataParallelTrainStep` with
ZeRO-1's `ShardedAdamW`, as `train` runs on a machine with several cards)
on its rows of every global step.

The process the benchmark starts is rank 0, on the device it is given.
It starts ranks 1.. through `parallel.train`'s machinery (`_rank_main`:
the `spawn` start method, `distributed.initialize`, NCCL on the cards,
gloo on the host), each on its card. Every rank builds the trainer, loads
the seed's weights and makes its own pool: `pool` global batches of
`batch` x ranks rows, of which it makes and keeps its data index's
`batch` rows (the rows and the draws as `drivers.train` makes them, for
the global batch). One `unit()` is one G+D step on every rank: rank 0
sends each other rank the step's pool index on a queue outside the
process group, then steps itself. A rank waits only for commands; rank 0
watches the other ranks' processes and ends the run (exit code 2, no
result) when one ends before it is told to stop, so nobody waits on a
collective that never comes; a rank whose parent is gone ends itself.

Traffic keys: those of `drivers.train` (`batch` a rank), and `ranks`.

The check: the set-up's `check_steps` steps through the window's call,
against `reference/train.py` on the global batch (every rank's rows) on
rank 0's device, with the same draws: each step's G and D loss, the first
clipped gradient norm of every leaf (the optimizers' moments gathered
whole), each leaf's change, and one step after the window from the state
it left (`drivers.train.compare`); and `rank_param_max_abs`, the largest
difference of any rank's parameters from rank 0's after the window (the
ranks promise to stay equal bit for bit).
"""

from __future__ import annotations

import importlib
import os
import shutil
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench import signals
from portbench.drivers import common, train
from portbench.reference import dsp
from portbench.reference import train as RT

STOP = ("stop",)


def make_pool(config: dict, traffic: dict, seed: int, device, rows: slice,
              which: Optional[List[int]] = None) -> Tuple[list, list]:
    """(batches, draws) of the pool's global batches (`which`: those only,
    None elsewhere), each cut to `rows` of its batch x ranks: the rows of
    `drivers.train.make_pool` for a batch of that size, each row's voice
    made alone, every draw made for the whole global batch."""
    t, d = traffic, config["data"]
    B, T, P = t["batch"] * t["ranks"], t["frames"], t["pool"]
    hop, sr = d["hop_length"], d["sample_rate"]
    n_short = int(round(t["short_share"] * B * P))
    lens = np.full(B * P, T)
    lens[:n_short] = np.linspace(*t["short_frames"], n_short).round().astype(int)
    lens = lens[signals.rng(seed, 4).permutation(B * P)]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 62) + 17)
    seg = config["train"]["segment_size"] // hop
    C = config["model"]["inter_channels"]
    idx = range(B)[rows]
    pool, draws = [None] * P, [None] * P
    for b in range(P):
        phone = torch.randn(B, T, 768, generator=gen, device=device)
        u = torch.rand(B, generator=gen, device=device)
        eps = torch.randn(B, T, C, generator=gen, device=device)
        noise = torch.randn(B, seg * hop, generator=gen, device=device)
        if which is not None and b not in which:
            continue
        n_rows = lens[b * B:(b + 1) * B][rows]
        wave = torch.zeros(len(idx), T * hop, device=device)
        f0 = torch.zeros(len(idx), T, device=device)
        for j, (i, n) in enumerate(zip(idx, n_rows)):
            y, f = signals.voice(n / 100.0, t["voice"], seed * 31 + b * B + i, device, sr=sr,
                                 with_f0=True)
            wave[j, : n * hop] = y[: n * hop]
            f0[j, :n] = f[: n * hop: hop][:n]
        lengths = torch.from_numpy(n_rows).to(device)
        valid = (torch.arange(T, device=device)[None] < lengths[:, None]).float()
        spec = dsp.spectrogram(wave, d["filter_length"], hop, d["win_length"])[:, :T]
        pool[b] = dict(phone=phone[rows] * valid[..., None], lengths=lengths,
                       pitch=dsp.coarse_f0(f0), pitchf=f0, spec=spec * valid[..., None],
                       wave=wave, sid=torch.full((len(idx),), t["sid"], device=device))
        top = torch.clamp(lengths - seg, min=0)
        draws[b] = RT.Draws(eps=eps[rows],
                            ids=torch.minimum((u[rows] * (top + 1).float()).long(), top),
                            noise=noise[rows])
    return pool, draws


class Rank:
    """One rank's trainer, pool and step; every rank runs the same calls
    (the steps and the collectives of the check) in the same order."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        import torch.distributed as dist

        from rvc_tpu_torch.configs import config_from_dict
        from rvc_tpu_torch.monitoring import NullTracker
        from rvc_tpu_torch.parallel.mesh import make_mesh
        from rvc_tpu_torch.train.data import DataLoader, RVCDataset
        from rvc_tpu_torch.train.trainer import RVCTrainer

        common.strict_float32()
        self.config, self.traffic, self.device = config, traffic, torch.device(device)
        self.rank, B, P = dist.get_rank(), traffic["batch"], traffic["pool"]
        cfg = config_from_dict(config)
        self.dir = tempfile.mkdtemp(prefix=f"portbench_dp{self.rank}_")
        # an epoch is the pool: the learning rate's steps per epoch
        loader = DataLoader(RVCDataset([{}] * (B * traffic["ranks"] * P), cfg.data.hop_length),
                            B, num_hosts=traffic["ranks"], host_id=self.rank)
        self.trainer = RVCTrainer(cfg, loader, checkpoint_dir=self.dir, seed=seed,
                                  tracker=NullTracker(), mesh=make_mesh(), device=self.device)
        self.start = common.seeded_states(config, seed, self.device, train.KINDS, training=True)
        self.trainer.net_g.load_state_dict(self.start["synthesizer"])
        self.trainer.net_d.load_state_dict(self.start["discriminator"])
        self.step_fn = self.trainer.step_fn(True)
        d = self.trainer.data_axis
        self.pool, self.draws = make_pool(config, traffic, seed, self.device,
                                          slice(d.index * B, (d.index + 1) * B))

    def nets(self):
        return self.trainer.net_g, self.trainer.net_d

    def step(self, i: int) -> Dict[str, torch.Tensor]:
        d = self.draws[i]
        return self.step_fn(train._batch(self.pool[i]), eps=d.eps, ids_slice=d.ids,
                            source_noise=d.noise[:, :, None])

    def whole_nu(self) -> List[List[torch.Tensor]]:
        """The optimizers' second moments, whole (a collective)."""
        return [opt._whole(opt.nu) for opt in (self.trainer.g_opt, self.trainer.d_opt)]

    def param_gap(self) -> float:
        """The largest |p - rank 0's p| over every rank and parameter (a
        collective; every rank gets it)."""
        import torch.distributed as dist

        params = [p.detach() for net in self.nets() for p in net.parameters()]
        flat = torch.cat([p.reshape(-1) for p in params])
        ref = flat.clone()
        dist.broadcast(ref, 0)
        gap = (flat - ref).abs().max().reshape(1)
        dist.all_reduce(gap, op=dist.ReduceOp.MAX)
        return float(gap)

    def sync(self) -> None:
        common.sync(self.device)

    def close(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)


def call(rank: Rank, name: str, *args):
    """A Rank method, or an importable "module:function" given the Rank."""
    if ":" in name:
        mod, fn = name.split(":")
        return getattr(importlib.import_module(mod), fn)(rank, *args)
    return getattr(rank, name)(*args)


def _watch_parent(parent: int) -> None:
    while True:
        if os.getppid() != parent:
            os._exit(3)
        time.sleep(0.5)


def serve(config: dict, traffic: dict, seed: int, host: bool, parent: int, commands,
          replies) -> None:
    """Ranks 1..: build the rank, then run the commands rank 0 sends (a
    `call` name and its arguments) until told to stop."""
    threading.Thread(target=_watch_parent, args=(parent,), daemon=True).start()
    device = torch.device("cpu") if host else torch.device("cuda", torch.cuda.current_device())
    rank = Rank(config, traffic, seed, device)
    replies.put(("ready", rank.rank))
    while True:
        cmd = commands.get()
        if cmd == STOP:
            rank.sync()
            rank.close()
            return
        call(rank, *cmd)


def _worker(i: int, world: int, init_method: str, threads: Optional[int], host: bool,
            args: tuple) -> None:
    """Process i of the spawned ones: rank i + 1, joined as `parallel.train.
    spawn` joins its ranks (gloo on the host, else NCCL on card i + 1)."""
    from rvc_tpu_torch.parallel.train import _rank_main

    _rank_main(i + 1, world, init_method, None, "cpu" if host else None, threads, serve, args)


class Driver(train.Driver):
    def setup(self) -> None:
        import torch.multiprocessing as mp

        from rvc_tpu_torch.parallel.distributed import initialize
        from rvc_tpu_torch.parallel.train import free_port

        t, world = self.traffic, self.traffic["ranks"]
        host = self.device.type == "cpu"
        init_method = f"tcp://localhost:{free_port()}"
        ctx = mp.get_context("spawn")
        self.commands = [ctx.SimpleQueue() for _ in range(world - 1)]
        self.replies = ctx.SimpleQueue()
        threads = self.config.get("host_threads")
        self._closing = False
        self.procs = [ctx.Process(target=_worker,
                                  args=(i, world, init_method, threads, host,
                                        (self.config, t, self.seed, host, os.getpid(),
                                         self.commands[i], self.replies)), daemon=True)
                      for i in range(world - 1)]
        for p in self.procs:
            p.start()
        threading.Thread(target=self._watch, daemon=True).start()
        initialize(init_method, world, 0, device="cpu" if host else self.device)
        self.me = Rank(self.config, t, self.seed, self.device)
        for _ in range(world - 1):
            self.replies.get()
        self.first = {}
        self.losses: List[Dict[str, float]] = []
        b2 = self.config["train"]["betas"][1]
        for k in range(t["check_steps"]):
            out = self._step()
            self.losses.append({n: float(out[n]) for n in ("loss_g_total", "loss_d")})
            if k == 0:
                for net, nu in zip(self.me.nets(), self.on_ranks("whole_nu")):
                    self.first.update(RT.first_grad_norms(
                        nu, [n for n, _ in net.named_parameters()], b2))
        self.change = {}
        for kind, net in zip(train.KINDS, self.me.nets()):
            for n, p in net.named_parameters():
                self.change[n] = float((p.detach() - self.me.start[kind][n]).norm())
        self.me.start = None

    def _watch(self) -> None:
        """End the run when a rank ends before it is told to stop."""
        while not self._closing:
            for r, p in enumerate(self.procs, start=1):
                if p.exitcode is not None and not self._closing:
                    print(f"portbench: rank {r} ended (exit code {p.exitcode}) before the "
                          f"run did", file=sys.stderr, flush=True)
                    for q in self.procs:
                        if q.is_alive():
                            q.kill()
                    os._exit(2)
            time.sleep(0.2)

    def on_ranks(self, name: str, *args):
        """`call(rank, name, *args)` on every rank (name: a Rank method or
        "module:function"); rank 0's result."""
        for q in self.commands:
            q.put((name, *args))
        return call(self.me, name, *args)

    def _step(self):
        i = self.k % len(self.me.pool)
        self.k += 1
        return self.on_ranks("step", i)

    def finish(self) -> None:
        self.me.sync()

    def roots(self) -> Dict[str, object]:
        return {"step": self.me.step_fn}

    # -------------------------------------------------------------- check
    def release(self) -> None:
        """Before the program is freed: the ranks' largest parameter gap,
        rank 0's weights as the window left them and one more step from
        there (as `drivers.train`); then every rank stops."""
        self.counts()
        self.gap = self.on_ranks("param_gap")
        self.late_state = {n: p.detach().clone() for net in self.me.nets()
                           for n, p in net.named_parameters()}
        self.late_index = self.k % len(self.me.pool)
        out = self._step()
        self.late = {n: float(out[n]) for n in ("loss_g_total", "loss_d")}
        self.window_losses = []
        import torch.distributed as dist

        self._closing = True
        for q in self.commands:
            q.put(STOP)
        self.me.sync()
        # every rank leaves the group at once: NCCL's finalize waits for all
        dist.destroy_process_group()
        deadline = time.monotonic() + 60
        for p in self.procs:
            p.join(timeout=max(deadline - time.monotonic(), 0.1))
            if p.is_alive():            # its work is done; do not wait on its exit
                p.kill()
        self.me.close()
        self.me = None

    def _global(self):
        """The global batches the reference takes, every rank's rows."""
        t = self.traffic
        idx = sorted({k % t["pool"] for k in range(t["check_steps"])} | {self.late_index})
        return make_pool(self.config, t, self.seed, self.device,
                         slice(0, t["batch"] * t["ranks"]), idx)

    def check(self, limits: dict) -> Dict[str, dict]:
        self.gpool, self.gdraws = self._global()
        self.ref = train.reference_run(self.config, self.seed, self.device, self.gpool,
                                       self.gdraws, self.traffic["check_steps"],
                                       self.late_state, self.late_index)
        out = train.compare(self.losses, self.first, self.change, self.late, self.ref, limits)
        out["rank_param_max_abs"] = common.verdict(self.gap, limits["rank_param_max_abs"])
        return out

    def control(self, limits: dict, half_batch: bool = False) -> Dict[str, dict]:
        pool, draws = self.gpool, self.gdraws
        if half_batch:
            h = self.traffic["batch"] * self.traffic["ranks"] // 2
            pool = [None if b is None else {k: v[:h] for k, v in b.items()} for b in pool]
            draws = [None if d is None else RT.Draws(*(x[:h] for x in d)) for d in draws]
        other = train.reference_run(self.config, self.seed, self.device, pool, draws,
                                    self.traffic["check_steps"], self.late_state,
                                    self.late_index)
        out = train.compare([dict(x) for x in other["losses"]], other["first"],
                            other["change"], other["late"], self.ref, limits)
        out["rank_param_max_abs"] = common.verdict(self.gap, limits["rank_param_max_abs"])
        return out
