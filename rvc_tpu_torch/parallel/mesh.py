"""The ("data", "model") mesh and its sharding rules (counterpart of
`rvc_tpu/parallel/mesh.py`).

A `Mesh` lists its members row-major, `n_model` to a row, as
`rvc_tpu/parallel/mesh.py:32` reshapes its devices: member i sits at data
index i // n_model and model index i % n_model. The members are torch
devices (`BatchConverter` splits a batch's rows over the "data" axis in
one process, and may name a card more than once) or the ranks of the
process group (the trainer, one rank a card).

The rules pick, for every parameter, the dimension a rank holds a 1/n_model
slice of (tensor parallelism, "model") and, for every optimizer moment,
the dimension it is further split along over "data" (ZeRO-1). They are
the reference's rules, copied (the port imports nothing of `rvc_tpu`):

- `SEMANTIC_TP_RULES` (`_SEMANTIC_TP_RULES`, `:75-99`) on the reference's
  parameter paths: the attention's QKV column-parallel (by heads) and O
  row-parallel, the FFN's conv_1 column and conv_2 row, the decoder
  ResBlocks' convs1 column and convs2 row; HuBERT's projections (no path
  runs HuBERT sharded: they are specs only); biases whole;
- `heuristic_spec` (`_spec_for_array`, `:45-62`) for every other leaf: a
  leaf of at least min_size elements splits its largest dimension the
  model size divides, with at least two rows a rank; a conv kernel (3-D
  and up) only a channel dimension, C_out first;
- `zero1_dim` (`_zero1_spec`, `:127-142`): a moment of at least min_size
  elements splits its largest dimension not taken by "model" that the
  data size divides.

Specs are tuples of axis names (None, "model", "data") over the reference's
layout: conv kernels (K, C_in, C_out), 2-D convs (KH, KW, C_in, C_out),
Linear (out, in). `tp_dim` carries a rule's choice to the port's torch
layout through `utils.weights.jax_layouts`, which names each torch
parameter's path and dimension order in `rvc_tpu`.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Sequence, Tuple, Union

import torch

MIN_SIZE = 1 << 16          # the reference's min_size default, for TP and ZeRO-1 alike

Spec = Tuple[Optional[str], ...]


class Mesh(NamedTuple):
    """The mesh's members, row-major with n_model to a row: torch devices,
    or the process group's ranks."""
    members: Tuple[Union[torch.device, int], ...]
    n_model: int = 1

    @property
    def shape(self) -> dict:
        return {"data": len(self.members) // self.n_model, "model": self.n_model}

    @property
    def size(self) -> int:
        return len(self.members)

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        """The members as devices (a mesh of ranks has none here)."""
        if any(isinstance(m, int) for m in self.members):
            raise ValueError("a mesh of ranks holds no devices of this process")
        return self.members

    def coords(self, i: int) -> Tuple[int, int]:
        """(data index, model index) of member i."""
        return divmod(i, self.n_model)


@dataclass(frozen=True)
class Axis:
    """One axis of the mesh as a rank sees it: its size, the rank's index
    along it, and the process group of the ranks along it (None: the
    default group where they are all the ranks, or no group where size is
    1 or where nothing is exchanged, as in counting a rank's bytes)."""
    size: int = 1
    index: int = 0
    group: Any = None


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
    every member n_model divides into."""
    if devices is None:
        if torch.distributed.is_available() and torch.distributed.is_initialized():
            members = tuple(range(torch.distributed.get_world_size()))
        else:
            members = tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    else:
        members = tuple(indexed_device(d) for d in devices)
    if n_model < 1:
        raise ValueError(f"n_model={n_model}")
    n_data = len(members) // n_model if n_data is None else n_data
    if not 1 <= n_data * n_model <= len(members):
        raise ValueError(f"a ({n_data}, {n_model}) mesh over {len(members)} devices or ranks")
    return Mesh(members[:n_data * n_model], n_model)


# ---------------------------------------------------------------------------
# the rules, on the reference's paths and layouts
# ---------------------------------------------------------------------------

_COL3, _ROW3 = (None, None, "model"), (None, "model", None)
_COL2, _ROW2 = ("model", None), (None, "model")
SEMANTIC_TP_RULES = (
    # synthesizer enc_p attention: QKV split by heads (column), O row
    (re.compile(r"(conv_q|conv_k|conv_v)/\w+$"), {3: _COL3, 1: ()}),
    (re.compile(r"conv_o/\w+$"), {3: _ROW3, 1: ()}),
    # synthesizer FFN: hidden dim column, projection back row
    (re.compile(r"ffn_layers_\d+/conv_1/\w+$"), {3: _COL3, 1: ()}),
    (re.compile(r"ffn_layers_\d+/conv_2/\w+$"), {3: _ROW3, 1: ()}),
    # HuBERT attention and FFN (torch Linear layout (out, in))
    (re.compile(r"(q_proj|k_proj|v_proj)/\w+$"), {2: _COL2, 1: ()}),
    (re.compile(r"out_proj/\w+$"), {2: _ROW2, 1: ()}),
    (re.compile(r"intermediate_dense/\w+$"), {2: _COL2, 1: ()}),
    (re.compile(r"output_dense/\w+$"), {2: _ROW2, 1: ()}),
    # decoder ResBlock pairs: convs1 column, convs2 row
    (re.compile(r"resblocks_\d+/convs1_\d+/\w+$"), {3: _COL3, 1: ()}),
    (re.compile(r"resblocks_\d+/convs2_\d+/\w+$"), {3: _ROW3, 1: ()}),
)


def _numel(shape: Sequence[int]) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def heuristic_spec(shape: Sequence[int], model_size: int, min_size: int = MIN_SIZE) -> Spec:
    """The shape rule for a leaf no semantic rule names."""
    ndim = len(shape)
    if model_size <= 1 or _numel(shape) < min_size:
        return ()
    dims = sorted(range(ndim), key=lambda i: -shape[i])
    if ndim >= 3:
        dims = [ndim - 1, ndim - 2]     # a conv kernel: C_out, then C_in
    for d in dims:
        if shape[d] % model_size == 0 and shape[d] >= 2 * model_size:
            return tuple("model" if i == d else None for i in range(ndim))
    return ()


def semantic_spec(path: str, shape: Sequence[int], model_size: int,
                  min_size: int = MIN_SIZE) -> Optional[Spec]:
    """The semantic table's spec for `path`, or None where no rule names it
    (or names it but not at this rank of tensor)."""
    ndim = len(shape)
    for pat, by_ndim in SEMANTIC_TP_RULES:
        if pat.search(path):
            if ndim >= 2 and _numel(shape) < min_size:
                return ()
            spec = by_ndim.get(ndim)
            if spec is None:
                return None
            for d, axis in enumerate(spec):
                if axis == "model" and (shape[d] % model_size or shape[d] < 2 * model_size):
                    return ()
            if ndim == 1 and _numel(shape) < 2 * model_size:
                return ()
            return spec
    return None


def tp_spec(path: str, shape: Sequence[int], model_size: int, min_size: int = MIN_SIZE) -> Spec:
    """A parameter's "model" spec: the semantic table, else the heuristic."""
    spec = semantic_spec(path, shape, model_size, min_size)
    return heuristic_spec(shape, model_size, min_size) if spec is None else spec


def tp_dim(path: str, jax_shape: Sequence[int], perm: Sequence[int], model_size: int,
           min_size: int = MIN_SIZE) -> Optional[int]:
    """The torch dimension a parameter splits along over "model" (None: whole
    on every rank), for its reference path and shape; perm[j] is the torch
    dimension of the reference's dimension j."""
    if model_size <= 1:
        return None
    spec = tp_spec(path, jax_shape, model_size, min_size)
    return perm[spec.index("model")] if "model" in spec else None


def zero1_dim(shape: Sequence[int], data_size: int, taken: Optional[int] = None,
              min_size: int = MIN_SIZE) -> Optional[int]:
    """The dimension a moment of (whole) `shape` splits along over "data", or
    None where it stays whole on the rank; `taken` is the dimension its
    parameter already splits along over "model"."""
    if data_size <= 1 or _numel(shape) < min_size:
        return None
    for d in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if d != taken and shape[d] % data_size == 0 and shape[d] >= 2 * data_size:
            return d
    return None
