"""The data-parallel mesh and the ZeRO-1 rule (counterpart of
`rvc_tpu/parallel/mesh.py`, the part its "data" axis needs).

A `Mesh` lists what sits along "data": torch devices (`BatchConverter`
splits a batch's rows over them in one process, and may name a card more
than once) or the ranks of the process group (the trainer, one rank per
card). Its "model" axis is 1: tensor parallelism, the reference's semantic
TP table (`rvc_tpu/parallel/mesh.py:66-125`), is not ported
(ROADMAP, "Tensor parallelism").

ZeRO-1 (`zero1_dim`, the reference's `_zero1_spec` on a replicated base
spec): an optimizer moment of at least ZERO1_MIN_SIZE elements is split over
"data" along its largest dimension that the data size divides, with at
least two rows a rank; smaller moments and scalars stay whole on every
rank.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

ZERO1_MIN_SIZE = 1 << 16
TP_NOT_PORTED = ("tensor parallelism (n_model > 1) is not ported: ROADMAP.md, modules "
                 "still to port, 'Tensor parallelism'")


class Mesh(NamedTuple):
    """The "data" axis: torch devices, or the process group's ranks."""
    members: Tuple[Union[torch.device, int], ...]

    @property
    def shape(self) -> dict:
        return {"data": len(self.members), "model": 1}

    @property
    def size(self) -> int:
        return len(self.members)

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        """The members as devices (a mesh of ranks has none here)."""
        if any(isinstance(m, int) for m in self.members):
            raise ValueError("a mesh of ranks holds no devices of this process")
        return self.members


def indexed_device(d) -> torch.device:
    """A device with its index: "cuda" is the current card."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ("data", "model") mesh. devices None: the process group's ranks
    where one is initialised, else every visible card. n_data None takes
    them all."""
    if n_model != 1:
        raise NotImplementedError(TP_NOT_PORTED)
    if devices is None:
        if torch.distributed.is_available() and torch.distributed.is_initialized():
            members = tuple(range(torch.distributed.get_world_size()))
        else:
            members = tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    else:
        members = tuple(indexed_device(d) for d in devices)
    n_data = len(members) if n_data is None else n_data
    if not 1 <= n_data <= len(members):
        raise ValueError(f"n_data={n_data} with {len(members)} devices or ranks")
    return Mesh(members[:n_data])


def zero1_dim(shape: Sequence[int], data_size: int) -> Optional[int]:
    """The dimension a moment of `shape` splits along over "data", or None
    where it stays whole."""
    numel = 1
    for s in shape:
        numel *= s
    if data_size <= 1 or numel < ZERO1_MIN_SIZE:
        return None
    for d in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[d] % data_size == 0 and shape[d] >= 2 * data_size:
            return d
    return None
