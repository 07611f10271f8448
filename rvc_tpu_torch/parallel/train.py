"""Training on a ("data", "model") mesh of the process group's ranks
(counterpart of `rvc_tpu/parallel/train.py`).

One rank a card. A rank's data index picks its rows of the global batch;
the ranks of one model group (equal data index) read the same rows and
hold the model's shards (`parallel.tp`; with n_model 1, a whole replica
each). `DataParallelTrainStep` gives the update of the global batch, as
the reference's sharded step does under GSPMD:

- every draw (the posterior's eps, the segment starts, the decoder's
  noise) is made for the whole global batch from a generator seeded alike
  on every rank, and each rank keeps its data index's rows
  (`ops.commons.batch_rows`);
- the KL's normaliser is the global mask sum (an all-reduce over the data
  group in the forward); the other losses are means over shapes equal on
  every rank;
- the gradients are all-reduced by hand (SUM, then / size: gloo has no
  AVG), coalesced into flat buffers of at most BUCKET_BYTES, since the
  step takes them with `torch.autograd.grad`, where DDP's hooks do not
  fire: a sharded parameter's over its data group; a whole one's over
  every rank, which averages its model group's copies too (equal where
  the kernels are deterministic, kept equal where they are not).
  Sanitizing and the global-norm clip then act on the global gradient,
  the norm summing the shards' squares over the model group
  (`ShardedAdamW.norm`);
- the D update's gate reads the all-reduced D loss, so the ranks skip
  together; the seven metrics come back as the global batch's.

`ShardedAdamW` is ZeRO-1 on top of tensor parallelism: each rank keeps
both moments of its data slice (`mesh.zero1_dim`, on a dimension "model"
does not take) of its shard of every large parameter, updates that slice
(on the card one call of the AdamW kernel over every slice) and
all-gathers the slices over its data group. Ranks of a data group start
equal (`broadcast_modules` from its first rank) and stay equal bit for bit.

With RVC_TPU_TRACE=1 the collectives of `all_reduce_mean` and
`all_gather_coalesced` are the spans dp/all_reduce and dp/all_gather.

`spawn` starts one process a rank (the `spawn` start method: CUDA cannot
live in a forked child), joins them at a fresh localhost port and runs a
function of this module in each: `cli_train` (`train` on a machine with
several cards, or `--mesh_model` ranks on the host) or `trainer_job` (a
step job, for tests and checks).
"""

from __future__ import annotations

import os
import socket
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from rvc_tpu_torch.ops.commons import batch_rows
from rvc_tpu_torch.ops.kernels import adamw as K
from rvc_tpu_torch.parallel import tp
from rvc_tpu_torch.parallel.distributed import initialize
from rvc_tpu_torch.parallel.mesh import MIN_SIZE, Axis, zero1_dim
from rvc_tpu_torch.train.optim import AdamW
from rvc_tpu_torch.train.train_step import TrainStep
from rvc_tpu_torch.utils.profiling import trace_span

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


def _world() -> Axis:
    """Every rank of the process group as one axis."""
    return Axis(dist.get_world_size(), dist.get_rank())


def all_reduce_mean(tensors: Sequence[torch.Tensor], axis: Optional[Axis] = None
                    ) -> List[torch.Tensor]:
    """The mean over the axis's ranks (default: all) of each tensor (new
    tensors), in coalesced all-reduces."""
    axis = axis or _world()
    out = list(tensors)
    if axis.size == 1:
        return out
    with trace_span("dp/all_reduce"):
        for idx in _buckets(out):
            flat = _flat(out, idx)
            dist.all_reduce(flat, group=axis.group)
            flat /= axis.size
            for i, piece in zip(idx, flat.split([out[i].numel() for i in idx])):
                out[i] = piece.view_as(out[i])
    return out


def all_gather_coalesced(slices: Sequence[torch.Tensor], axis: Optional[Axis] = None
                         ) -> List[List[torch.Tensor]]:
    """[r][i]: tensor i of the axis's rank r (equal shapes on every rank),
    in coalesced all-gathers."""
    axis = axis or _world()
    if axis.size == 1:
        return [list(slices)]
    out = [[None] * len(slices) for _ in range(axis.size)]
    with trace_span("dp/all_gather"):
        for idx in _buckets(slices):
            flat = _flat(slices, idx)
            parts = [torch.empty_like(flat) for _ in range(axis.size)]
            dist.all_gather(parts, flat, group=axis.group)
            for r, part in enumerate(parts):
                for i, piece in zip(idx, part.split([slices[i].numel() for i in idx])):
                    out[r][i] = piece.view(slices[i].shape)
    return out


def broadcast_modules(*modules: torch.nn.Module, group=None, src: int = 0) -> None:
    """Every tensor of the modules' state from rank `src` (a global rank)
    of `group` (default: all ranks), in place."""
    tensors = [t for m in modules for t in m.state_dict().values()]
    for idx in _buckets(tensors):
        flat = _flat(tensors, idx)
        dist.broadcast(flat, src, group=group)
        for i, piece in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            tensors[i].copy_(piece.view_as(tensors[i]))


class ShardedAdamW(AdamW):
    """AdamW with ZeRO-1 moments over the data axis, on top of each
    parameter's tensor-parallel shard: a parameter that `zero1_dim` splits
    (its whole shape, min_size, the dimension "model" takes) has its
    moments, and its update, on this rank's data slice only; the updated
    slices are all-gathered over the data group after each step. `norm`
    sums the squares of the shards over the model group and counts whole
    parameters once. The state dict is the single-card format (whole
    moments; a collective, so every rank calls it); `load_state_dict`
    takes that format and keeps the rank's slices. data / model default to
    every rank on "data"."""

    def __init__(self, params, lr: float, *, data: Optional[Axis] = None,
                 model: Optional[Axis] = None, min_size: int = MIN_SIZE, **kw):
        params = list(params)
        self.data, self.model = data or _world(), model or Axis()
        self.tp_dims = [tp.shard_dim(p) for p in params]
        self.dims = [zero1_dim(tp.whole_shape(p), self.data.size, d, min_size)
                     for p, d in zip(params, self.tp_dims)]
        self.sharded = [i for i, d in enumerate(self.dims) if d is not None]
        self.gathered_bytes = 0     # all-gathered by the steps so far
        super().__init__(params, lr, **kw)

    def _slice(self, i: int, t: torch.Tensor, index: int) -> torch.Tensor:
        d = self.dims[i]
        if d is None:
            return t
        n = t.shape[d] // self.data.size
        return t.narrow(d, index * n, n)

    def _local(self, i: int, t: torch.Tensor) -> torch.Tensor:
        return self._slice(i, t, self.data.index)

    @torch.no_grad()
    def _share(self) -> None:
        if not self.sharded:
            return
        mine = [self._local(i, self.params[i]) for i in self.sharded]
        parts = all_gather_coalesced(mine, self.data)
        self.gathered_bytes += sum(t.numel() * t.element_size() for t in mine) * self.data.size
        for r in range(self.data.size):
            if r != self.data.index:
                for j, i in enumerate(self.sharded):
                    self._slice(i, self.params[i], r).copy_(parts[r][j])

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor],
             gate: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`AdamW.step` on this rank's slices: one `ops.kernels.adamw` call
        over `_local`'s views (on the CPU the per-tensor loop) from the whole
        gradients, whose norm it computes, or takes from `norm` over a model
        axis (a collective); then `_share`. Returns the norm."""
        with trace_span("optim/adamw"):
            given = None if self.model.size == 1 else self.norm(K.sanitize_grads(grads))
            g_norm = K.adamw(self.layout(), grads, self.count, self.hyper, gate, given)
            self._share()
            return g_norm

    def norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The global norm of the whole model's gradient from this rank's
        shards over the model axis (a collective)."""
        whole = torch.zeros((), device=grads[0].device)
        shards = torch.zeros(1, device=grads[0].device)
        for g, d in zip(grads, self.tp_dims):
            if d is None:
                whole = whole + torch.sum(g.float() ** 2)
            else:
                shards = shards + torch.sum(g.float() ** 2)
        return torch.sqrt(whole + tp.all_reduce_model(shards, self.model)[0])

    def _whole(self, moments: List[torch.Tensor]) -> List[torch.Tensor]:
        """Whole moments from every rank's slices (over data, then model)."""
        out = list(moments)
        if self.sharded:
            parts = all_gather_coalesced([moments[i] for i in self.sharded], self.data)
            for j, i in enumerate(self.sharded):
                out[i] = torch.cat([parts[r][j] for r in range(self.data.size)],
                                   dim=self.dims[i])
        split = [i for i, d in enumerate(self.tp_dims) if d is not None]
        if split and self.model.size > 1:
            parts = all_gather_coalesced([out[i] for i in split], self.model)
            for j, i in enumerate(split):
                out[i] = torch.cat([parts[r][j] for r in range(self.model.size)],
                                   dim=self.tp_dims[i])
        return out

    def state_dict(self) -> Dict[str, object]:
        return {"mu": [t.detach().cpu() for t in self._whole(self.mu)],
                "nu": [t.detach().cpu() for t in self._whole(self.nu)],
                "count": self.count.cpu().clone()}

    def _own(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of parameter i's whole moment t."""
        d = self.tp_dims[i]
        if d is not None:
            n = t.shape[d] // self.model.size
            t = t.narrow(d, self.model.index * n, n)
        return self._local(i, t)

    def load_state_dict(self, state: Dict[str, object]) -> None:
        super().load_state_dict({
            "mu": [self._own(i, t) for i, t in enumerate(state["mu"])],
            "nu": [self._own(i, t) for i, t in enumerate(state["nu"])],
            "count": state["count"]})


class DataParallelTrainStep(TrainStep):
    """`TrainStep` on this rank's rows and shards, giving the global batch's
    update and metrics on a (data, model) mesh (see the module's
    docstring). data / model: this rank's axes (default: every rank on
    "data"). `all_reduced_bytes` counts what its data-axis collectives
    moved so far (the model axis's: `tp.COMM`)."""

    def __init__(self, *args, data: Optional[Axis] = None, model: Optional[Axis] = None,
                 **kw):
        super().__init__(*args, **kw)
        self.data, self.model = data or _world(), model or Axis()
        self.all_reduced_bytes = 0

    def _mean(self, tensors: Sequence[torch.Tensor], axis: Axis) -> List[torch.Tensor]:
        if axis.size > 1:
            self.all_reduced_bytes += sum(t.numel() * t.element_size() for t in tensors)
        return all_reduce_mean(tensors, axis)

    def kl_denominator(self, y_mask: torch.Tensor) -> torch.Tensor:
        total = torch.sum(y_mask.detach())
        if self.data.size > 1:
            dist.all_reduce(total, group=self.data.group)
            self.all_reduced_bytes += total.element_size()
        return torch.clamp(total, min=1.0) / self.data.size

    def reduce_grads(self, grads: List[torch.Tensor],
                     params: List[torch.Tensor]) -> List[torch.Tensor]:
        out = list(grads)
        for split, axis in ((False, _world()), (True, self.data)):
            idx = [i for i, p in enumerate(params) if (tp.shard_dim(p) is not None) == split]
            if idx and axis.size > 1:
                for i, g in zip(idx, self._mean([grads[i] for i in idx], axis)):
                    out[i] = g
        return out

    def reduce_loss(self, loss: torch.Tensor) -> torch.Tensor:
        return self._mean([loss], self.data)[0]

    def __call__(self, batch, generator: Optional[torch.Generator] = None,
                 **draws) -> Dict[str, torch.Tensor]:
        B = batch.phone.shape[0]
        with batch_rows(self.data.index * B, self.data.size * B):
            metrics = super().__call__(batch, generator, **draws)
        losses = self._mean([torch.stack([metrics[k] for k in _G_LOSSES])], self.data)[0]
        metrics.update(zip(_G_LOSSES, losses.unbind()))
        return metrics


def state_bytes_per_device(net_g: torch.nn.Module, net_d: torch.nn.Module, g_opt: AdamW,
                           d_opt: AdamW, n_devices: int) -> dict:
    """Global and per-device bytes of the parameters (this rank's shards)
    and of the optimizer state (moments and counts; this rank's ZeRO-1
    slices of its shards), under the reference's keys."""
    def nbytes(t):
        return t.numel() * t.element_size()

    def whole(p):
        n = 1
        for s in tp.whole_shape(p):
            n *= s
        return n

    params = [p for net in (net_g, net_d) for p in net.parameters()]
    glob = dev = 0
    for opt in (g_opt, d_opt):
        for p, mu, nu in zip(opt.params, opt.mu, opt.nu):
            glob += whole(p) * (mu.element_size() + nu.element_size())
            dev += nbytes(mu) + nbytes(nu)
        glob += nbytes(opt.count)
        dev += nbytes(opt.count)
    return {"param_bytes_global": sum(whole(p) * p.element_size() for p in params),
            "param_bytes_per_device": sum(nbytes(p) for p in params),
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


def run_job(job: dict) -> tuple:
    """One rank of a step job (see `trainer_job`) through
    `RVCTrainer(mesh=...)`: returns (trainer, step, this rank's batch, its
    draws per step, the results)."""
    from rvc_tpu_torch.configs import config_from_dict
    from rvc_tpu_torch.monitoring import NullTracker
    from rvc_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from rvc_tpu_torch.parallel.mesh import MIN_SIZE, indexed_device, make_mesh
    from rvc_tpu_torch.train.data import DataLoader, RVCDataset
    from rvc_tpu_torch.train.train_step import Batch
    from rvc_tpu_torch.train.trainer import RVCTrainer

    cfg = config_from_dict(job["config"])
    world = dist.get_world_size()
    device = indexed_device(job["device"])
    mesh = make_mesh(n_model=job.get("mesh_model", 1))
    trainer = RVCTrainer(cfg, DataLoader(RVCDataset([], cfg.data.hop_length), 1),
                         checkpoint_dir=job["dir"], seed=job["seed"], tracker=NullTracker(),
                         mesh=mesh, device=device, tp_min_size=job.get("min_size", MIN_SIZE))
    data = trainer.data_axis
    B = job["batch"][0].shape[0] // data.size
    rows = slice(data.index * B, (data.index + 1) * B)
    batch = Batch(*(t[rows] for t in job["batch"])).to(device)
    draws = [{k: v[rows].to(device) for k, v in d.items()}
             for d in (job["draws"] or [{}] * job["steps"])]
    step = trainer.step_fn(True)
    metrics, ms = [], []
    _sync(device)
    reset_launches()
    tp.reset_comm()
    for s in range(job["steps"]):
        _sync(device)
        t0 = time.perf_counter()
        m = step(batch, trainer.generator, **draws[s])
        _sync(device)
        ms.append(1e3 * (time.perf_counter() - t0))
        metrics.append({k: float(v) for k, v in m.items()})
    out = {"metrics": metrics, "step_ms": ms, "launches": dict(LAUNCHES),
           "model_comm": dict(tp.COMM), "mesh": mesh.shape,
           "tp_kinds": {k: list(trainer.tp_kinds.values()).count(k) for k in ("pair", "gathered")},
           "data_index": data.index, "model_index": trainer.model_axis.index,
           "g": {k: v.cpu() for k, v in trainer.whole_state(trainer.net_g).items()},
           "d": {k: v.cpu() for k, v in trainer.whole_state(trainer.net_d).items()},
           "all_reduced_bytes": step.all_reduced_bytes,
           "all_gathered_bytes": trainer.g_opt.gathered_bytes + trainer.d_opt.gathered_bytes,
           "state_bytes": state_bytes_per_device(trainer.net_g, trainer.net_d, trainer.g_opt,
                                                 trainer.d_opt, world),
           "comm_ms": _comm_ms(trainer, step, device)}
    if job.get("moments"):
        out.update(g_opt=trainer.g_opt.state_dict(), d_opt=trainer.d_opt.state_dict())
    return trainer, step, batch, draws, out


def trainer_job(path: str) -> None:
    """One rank of the mesh's step job `path` (a `torch.save`d dict) through
    `RVCTrainer(mesh=...)`:

      config      `config_to_dict` of the model
      seed        the trainer's seed (init, and the draws' generator)
      device      this rank's device ("cpu", "cuda")
      batch       the global batch's 8 tensors (`Batch` order); a rank of
                  data index i takes rows i * B / n_data ...
      steps       adversarial steps to take on it
      draws       None (the trainer's generator draws them) or one dict of
                  global eps / ids_slice / source_noise per step
      mesh_model  optional: the model axis's size (1)
      min_size    optional: the sharding rules' min_size (1 << 16)
      moments     optional: True returns the optimizers' state (gathered)

    writes `path`.rank{r}: each step's metrics and host ms (synchronized),
    the kernels' launches and the model axis's collectives over the steps,
    the count of parameters sharded as pair members and as gathered leaves,
    G and D's whole state, the optimizer state where asked, the bytes the
    step all-reduced over "data" and all-gathered, `state_bytes_per_device`,
    and ms of one all-reduce of G's and D's gradients (as the step makes it)
    and one all-gather of G's and D's slices."""
    job = torch.load(path, weights_only=False)
    out = run_job(dict(job, dir=os.path.dirname(path)))[-1]
    torch.save(out, f"{path}.rank{dist.get_rank()}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _comm_ms(trainer, step: DataParallelTrainStep, device: torch.device) -> dict:
    """Host ms (synchronized) of one all-reduce of gradients the size of G's
    and D's, as the step makes it, and of one all-gather of the optimizers'
    slices."""
    params = [p for net in (trainer.net_g, trainer.net_d) for p in net.parameters()]
    grads = [torch.zeros_like(p) for p in params]
    out = {}
    for name, fn in (("all_reduce", lambda: step.reduce_grads(grads, params)),
                     ("all_gather", lambda: (trainer.g_opt._share(), trainer.d_opt._share()))):
        fn()
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        out[name] = 1e3 * (time.perf_counter() - t0)
    return out
