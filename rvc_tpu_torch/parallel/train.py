"""Data-parallel training over the process group's ranks (counterpart of
`rvc_tpu/parallel/train.py`, its "data" axis).

One rank a card, each with a whole replica of G and D and its own rows of
the global batch. `DataParallelTrainStep` gives the update of the global
batch, as the reference's sharded step does under GSPMD:

- every draw (the posterior's eps, the segment starts, the decoder's
  noise) is made for the whole global batch from a generator seeded alike
  on every rank, and each rank keeps its rows (`ops.commons.batch_rows`);
- the KL's normaliser is the global mask sum (an all-reduce in the
  forward); the other losses are means over shapes equal on every rank;
- the gradients are all-reduced by hand (SUM, then / world size: gloo has
  no AVG), coalesced into flat buffers of at most BUCKET_BYTES, since the
  step takes them with `torch.autograd.grad`, where DDP's hooks do not
  fire; sanitizing and the global-norm clip then act on the global
  gradient, which every rank holds;
- the D update's gate reads the all-reduced D loss, so the ranks skip
  together; the seven metrics come back as the global batch's.

`ShardedAdamW` is ZeRO-1: each rank keeps both moments of its slice of
every large parameter (`mesh.zero1_dim`), updates that slice and
all-gathers the slices into the whole parameter. Replicas start equal
(`broadcast_modules` from rank 0) and stay equal bit for bit.

`spawn` starts one process a rank (the `spawn` start method: CUDA cannot
live in a forked child), joins them at a fresh localhost port and runs a
function of this module in each: `cli_train` (`train` on a machine with
several cards) or `trainer_job` (a step job, for tests and checks).
"""

from __future__ import annotations

import os
import socket
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from rvc_tpu_torch.ops.commons import batch_rows
from rvc_tpu_torch.parallel.distributed import initialize
from rvc_tpu_torch.parallel.mesh import zero1_dim
from rvc_tpu_torch.train.optim import AdamW
from rvc_tpu_torch.train.train_step import TrainStep

BUCKET_BYTES = 1 << 26      # 64 MiB a collective
_G_LOSSES = ("loss_g_total", "loss_mel", "loss_kl", "loss_adv", "loss_fm")


def _buckets(tensors: Sequence[torch.Tensor]) -> List[List[int]]:
    """Indices of consecutive tensors of one dtype, at most BUCKET_BYTES a
    group (a larger tensor alone)."""
    out, cur, size = [], [], 0
    for i, t in enumerate(tensors):
        nbytes = t.numel() * t.element_size()
        if cur and (t.dtype != tensors[cur[0]].dtype or size + nbytes > BUCKET_BYTES):
            out.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += nbytes
    if cur:
        out.append(cur)
    return out


def _flat(tensors: Sequence[torch.Tensor], idx: Sequence[int]) -> torch.Tensor:
    return torch.cat([tensors[i].reshape(-1) for i in idx])


def all_reduce_mean(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The mean over the ranks of each tensor (new tensors), in coalesced
    all-reduces."""
    world = dist.get_world_size()
    out = list(tensors)
    for idx in _buckets(out):
        flat = _flat(out, idx)
        dist.all_reduce(flat)
        flat /= world
        for i, piece in zip(idx, flat.split([out[i].numel() for i in idx])):
            out[i] = piece.view_as(out[i])
    return out


def all_gather_coalesced(slices: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
    """[rank][i]: every rank's tensor i (equal shapes on every rank), in
    coalesced all-gathers."""
    world = dist.get_world_size()
    out = [[None] * len(slices) for _ in range(world)]
    for idx in _buckets(slices):
        flat = _flat(slices, idx)
        parts = [torch.empty_like(flat) for _ in range(world)]
        dist.all_gather(parts, flat)
        for r, part in enumerate(parts):
            for i, piece in zip(idx, part.split([slices[i].numel() for i in idx])):
                out[r][i] = piece.view(slices[i].shape)
    return out


def broadcast_modules(*modules: torch.nn.Module) -> None:
    """Every tensor of the modules' state from rank 0, in place."""
    tensors = [t for m in modules for t in m.state_dict().values()]
    for idx in _buckets(tensors):
        flat = _flat(tensors, idx)
        dist.broadcast(flat, 0)
        for i, piece in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            tensors[i].copy_(piece.view_as(tensors[i]))


class ShardedAdamW(AdamW):
    """AdamW with ZeRO-1 moments over the ranks: a parameter that
    `zero1_dim` splits has its moments, and its update, on rank r's slice
    only; the updated slices are all-gathered after each step. The state
    dict is the single-card format (whole moments; a collective, so every
    rank calls it); `load_state_dict` takes that format and keeps its
    slices."""

    def __init__(self, params, lr: float, **kw):
        params = list(params)
        self.world, self.rank = dist.get_world_size(), dist.get_rank()
        self.dims = [zero1_dim(p.shape, self.world) for p in params]
        self.sharded = [i for i, d in enumerate(self.dims) if d is not None]
        self.gathered_bytes = 0     # all-gathered by the steps so far
        super().__init__(params, lr, **kw)

    def _slice(self, i: int, t: torch.Tensor, rank: int) -> torch.Tensor:
        d = self.dims[i]
        if d is None:
            return t
        n = t.shape[d] // self.world
        return t.narrow(d, rank * n, n)

    def _local(self, i: int, t: torch.Tensor) -> torch.Tensor:
        return self._slice(i, t, self.rank)

    @torch.no_grad()
    def _share(self) -> None:
        if not self.sharded:
            return
        mine = [self._local(i, self.params[i]) for i in self.sharded]
        parts = all_gather_coalesced(mine)
        self.gathered_bytes += sum(t.numel() * t.element_size() for t in mine) * self.world
        for r in range(self.world):
            if r != self.rank:
                for j, i in enumerate(self.sharded):
                    self._slice(i, self.params[i], r).copy_(parts[r][j])

    def _whole(self, moments: List[torch.Tensor]) -> List[torch.Tensor]:
        parts = all_gather_coalesced([moments[i] for i in self.sharded])
        out = list(moments)
        for j, i in enumerate(self.sharded):
            out[i] = torch.cat([parts[r][j] for r in range(self.world)], dim=self.dims[i])
        return out

    def state_dict(self) -> Dict[str, object]:
        return {"mu": [t.detach().cpu() for t in self._whole(self.mu)],
                "nu": [t.detach().cpu() for t in self._whole(self.nu)],
                "count": self.count.cpu()}

    def load_state_dict(self, state: Dict[str, object]) -> None:
        super().load_state_dict({
            "mu": [self._local(i, t) for i, t in enumerate(state["mu"])],
            "nu": [self._local(i, t) for i, t in enumerate(state["nu"])],
            "count": state["count"]})


class DataParallelTrainStep(TrainStep):
    """`TrainStep` on this rank's rows, giving the global batch's update
    and metrics (see the module's docstring). `all_reduced_bytes` counts
    what its collectives moved so far."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.world, self.rank = dist.get_world_size(), dist.get_rank()
        self.all_reduced_bytes = 0

    def _mean(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        self.all_reduced_bytes += sum(t.numel() * t.element_size() for t in tensors)
        return all_reduce_mean(tensors)

    def kl_denominator(self, y_mask: torch.Tensor) -> torch.Tensor:
        total = torch.sum(y_mask.detach())
        dist.all_reduce(total)
        self.all_reduced_bytes += total.element_size()
        return torch.clamp(total, min=1.0) / self.world

    def reduce_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        return self._mean(grads)

    def reduce_loss(self, loss: torch.Tensor) -> torch.Tensor:
        return self._mean([loss])[0]

    def __call__(self, batch, generator: Optional[torch.Generator] = None,
                 **draws) -> Dict[str, torch.Tensor]:
        B = batch.phone.shape[0]
        with batch_rows(self.rank * B, self.world * B):
            metrics = super().__call__(batch, generator, **draws)
        losses = self._mean([torch.stack([metrics[k] for k in _G_LOSSES])])[0]
        metrics.update(zip(_G_LOSSES, losses.unbind()))
        return metrics


def state_bytes_per_device(net_g: torch.nn.Module, net_d: torch.nn.Module, g_opt: AdamW,
                           d_opt: AdamW, n_devices: int) -> dict:
    """Global and per-device bytes of the parameters (whole on every rank)
    and of the optimizer state (moments and counts; ZeRO-1 slices per
    device), under the reference's keys."""
    def nbytes(t):
        return t.numel() * t.element_size()

    params = sum(nbytes(p) for net in (net_g, net_d) for p in net.parameters())
    glob = dev = 0
    for opt in (g_opt, d_opt):
        for p, mu, nu in zip(opt.params, opt.mu, opt.nu):
            glob += p.numel() * (mu.element_size() + nu.element_size())
            dev += nbytes(mu) + nbytes(nu)
        glob += nbytes(opt.count)
        dev += nbytes(opt.count)
    return {"param_bytes_global": params, "param_bytes_per_device": params,
            "opt_bytes_global": glob, "opt_bytes_per_device": dev, "n_devices": n_devices}


# ---------------------------------------------------------------------------
# one process a rank
# ---------------------------------------------------------------------------

def free_port() -> int:
    """A localhost TCP port free at the time of asking."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, init_method: str, backend: Optional[str], device,
               threads: Optional[int], fn: Callable, args: tuple) -> None:
    if threads:
        torch.set_num_threads(threads)
    initialize(init_method, world, rank, backend=backend, device=device)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: tuple = (), *, init_method: Optional[str] = None,
          backend: Optional[str] = None, device=None, threads: Optional[int] = None) -> None:
    """fn(*args) on `world` ranks, one process each, joined at init_method
    (default: a free localhost port) by `distributed.initialize` (device
    None: rank r on card r % the cards, NCCL; "cpu": gloo). fn must be
    importable by name (a function of a module, never of `__main__`).
    Returns when every rank has; raises when one failed."""
    import torch.multiprocessing as mp

    init_method = init_method or f"tcp://localhost:{free_port()}"
    mp.start_processes(_rank_main, args=(world, init_method, backend, device, threads, fn,
                                         args),
                       nprocs=world, join=True, start_method="spawn")


def cli_train(args) -> None:
    """A rank of `train` started by `spawn` (one a card)."""
    from rvc_tpu_torch.cli import cmd_train

    cmd_train(args)


def trainer_job(path: str) -> None:
    """One rank of the data-parallel step job `path` (a `torch.save`d dict)
    through `RVCTrainer(mesh=...)`:

      config      `config_to_dict` of the model
      seed        the trainer's seed (init, and the draws' generator)
      device      this rank's device ("cpu", "cuda")
      batch       the global batch's 8 tensors (`Batch` order); rank r takes
                  rows r * B / world ...
      steps       adversarial steps to take on it
      draws       None (the trainer's generator draws them) or one dict of
                  global eps / ids_slice / source_noise per step
      moments     optional: True returns the optimizers' state (gathered)

    writes `path`.rank{r}: each step's metrics and host ms (synchronized),
    the kernels' launches over the steps, G and D's state, the optimizer
    state where asked, the bytes the step all-reduced and all-gathered,
    `state_bytes_per_device`, and ms of one all-reduce of G's and D's
    gradient sizes and one all-gather of G's and D's slices."""
    from rvc_tpu_torch.configs import config_from_dict
    from rvc_tpu_torch.monitoring import NullTracker
    from rvc_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from rvc_tpu_torch.parallel.mesh import indexed_device, make_mesh
    from rvc_tpu_torch.train.data import DataLoader, RVCDataset
    from rvc_tpu_torch.train.train_step import Batch
    from rvc_tpu_torch.train.trainer import RVCTrainer

    job = torch.load(path, weights_only=False)
    cfg = config_from_dict(job["config"])
    world, rank = dist.get_world_size(), dist.get_rank()
    device = indexed_device(job["device"])
    trainer = RVCTrainer(cfg, DataLoader(RVCDataset([], cfg.data.hop_length), 1),
                         checkpoint_dir=os.path.dirname(path),
                         seed=job["seed"], tracker=NullTracker(), mesh=make_mesh(),
                         device=device)
    B = job["batch"][0].shape[0] // world
    rows = slice(rank * B, (rank + 1) * B)
    batch = Batch(*(t[rows] for t in job["batch"])).to(device)
    step = trainer.step_fn(True)
    metrics, ms = [], []
    _sync(device)
    reset_launches()
    for s in range(job["steps"]):
        draws = {k: v[rows].to(device) for k, v in (job["draws"] or [{}] * job["steps"])[s].items()}
        _sync(device)
        t0 = time.perf_counter()
        m = step(batch, trainer.generator, **draws)
        _sync(device)
        ms.append(1e3 * (time.perf_counter() - t0))
        metrics.append({k: float(v) for k, v in m.items()})
    launches = dict(LAUNCHES)
    out = {"metrics": metrics, "step_ms": ms, "launches": launches,
           "g": {k: v.cpu() for k, v in trainer.net_g.state_dict().items()},
           "d": {k: v.cpu() for k, v in trainer.net_d.state_dict().items()},
           "all_reduced_bytes": step.all_reduced_bytes,
           "all_gathered_bytes": trainer.g_opt.gathered_bytes + trainer.d_opt.gathered_bytes,
           "state_bytes": state_bytes_per_device(trainer.net_g, trainer.net_d, trainer.g_opt,
                                                 trainer.d_opt, world),
           "comm_ms": _comm_ms(trainer, device)}
    if job.get("moments"):
        out.update(g_opt=trainer.g_opt.state_dict(), d_opt=trainer.d_opt.state_dict())
    torch.save(out, f"{path}.rank{rank}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _comm_ms(trainer, device: torch.device) -> dict:
    """Host ms (synchronized) of one all-reduce of gradients the size of G's
    and D's, and of one all-gather of the optimizers' slices."""
    grads = [torch.zeros_like(p) for net in (trainer.net_g, trainer.net_d)
             for p in net.parameters()]
    out = {}
    for name, fn in (("all_reduce", lambda: all_reduce_mean(grads)),
                     ("all_gather", lambda: (trainer.g_opt._share(), trainer.d_opt._share()))):
        fn()
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        out[name] = 1e3 * (time.perf_counter() - t0)
    return out
