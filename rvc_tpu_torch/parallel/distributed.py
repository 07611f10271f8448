"""Joining the ranks of a multi-card run (counterpart of
`rvc_tpu/parallel/distributed.py`).

One process a card: the reference's "host" is a rank here. `initialize`
joins the process group at the coordinator's address and puts the process
on its card; the trainer's loader then takes rank h's share of every
global step (`DataLoader(num_hosts, host_id)`). NCCL joins ranks on CUDA
devices, gloo on the CPU; neither falls back to the other.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from rvc_tpu_torch.parallel.mesh import Mesh, make_mesh


def _env_int(*names: str) -> Optional[int]:
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return int(v)
    return None


def _init_method(address: str) -> str:
    """host:port -> tcp://host:port; a tcp:// or file:// URL as it is."""
    return address if "://" in address else f"tcp://{address}"


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None,
               device=None) -> dict:
    """Join the process group when a coordinator is given (or set in the
    environment: COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID, or
    torchrun's MASTER_ADDR / MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK);
    without one, a single process and nothing to join.

    device: None or a CUDA device puts the rank on its card (LOCAL_RANK,
    else rank % the visible cards) and joins by NCCL; "cpu" joins by gloo.
    backend overrides that choice (gloo on the card, to join two ranks on
    one card, which NCCL refuses). Returns the reference's keys."""
    if coordinator_address is None:
        coordinator_address = os.environ.get("COORDINATOR_ADDRESS")
        if coordinator_address is None and os.environ.get("MASTER_ADDR"):
            coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                                   f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = _env_int("NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("PROCESS_ID", "RANK")
    if coordinator_address and not dist.is_initialized():
        if num_processes is None or process_id is None or not 0 <= process_id < num_processes:
            raise ValueError(f"a coordinator needs the process count and this process's id "
                             f"(got {num_processes}, {process_id})")
        cuda = device is None or torch.device(device).type == "cuda"
        card = None
        if cuda:
            if not torch.cuda.is_available():
                raise RuntimeError("rvc_tpu_torch runs on a CUDA device and none is "
                                   "available; pass device='cpu' to train on the host")
            local = _env_int("LOCAL_RANK")
            card = torch.device("cuda", local if local is not None
                                else process_id % torch.cuda.device_count())
            torch.cuda.set_device(card)
        backend = backend or ("nccl" if cuda else "gloo")
        if backend == "nccl" and not dist.is_nccl_available():
            raise RuntimeError("this PyTorch has no NCCL to join the ranks' cards")
        dist.init_process_group(backend, init_method=_init_method(coordinator_address),
                                world_size=num_processes, rank=process_id,
                                device_id=card if backend == "nccl" else None)
    count = dist.get_world_size() if dist.is_initialized() else 1
    return dict(process_index=dist.get_rank() if dist.is_initialized() else 0,
                process_count=count, local_devices=1, global_devices=count,
                backend=dist.get_backend() if dist.is_initialized() else None)


def global_mesh(n_model: int = 1) -> Mesh:
    """The data mesh over every rank (n_model > 1 raises: not ported)."""
    return make_mesh(n_model=n_model)


def host_shard_info() -> dict:
    if dist.is_initialized():
        return dict(num_hosts=dist.get_world_size(), host_id=dist.get_rank())
    return dict(num_hosts=1, host_id=0)
