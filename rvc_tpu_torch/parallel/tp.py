"""Tensor parallelism over the mesh's "model" axis (the collectives GSPMD
inserts into `rvc_tpu/parallel/train.py`'s sharded step, by hand).

`shard_modules` lays G and D out by the reference's rules (`parallel.mesh`):
each parameter the rules split keeps only the rank's 1/n_model slice
(`p.data` is replaced; `shard_dim(p)` and `whole_shape(p)` say how). Two
kinds:

- **pair** members (the semantic table's column / row pairs: the
  attention's QKV and O where the heads split evenly, the FFN's conv_1 and
  conv_2, a ResBlock's convs1 and convs2): the module computes on its
  shards (`module.tp` is the model `Axis`). Its input enters through
  `copy_to_model` (identity forward, all-reduce of the gradient backward),
  its row-parallel output leaves through `reduce_from_model` (all-reduce
  forward, identity backward) before its whole bias; a whole tensor used
  on the rank's columns only (a column-parallel layer's bias, the
  attention's shared rel-pos tables) goes through `copy_to_model` too, so
  that its gradient is summed over the columns. The decoder's ResBlock
  pairs run the partial-sum launch of K1/K2 (`ops.kernels.resblock.
  resblock_chain_tp`, `resblock_group_tp`).
- **gathered** leaves (every other leaf the heuristic splits): the owning
  module's forward sees the whole tensor, all-gathered at use
  (`gather_at_use`, forward hooks); the backward keeps the rank's own
  slice of the whole gradient. Every rank of a model group computes that
  whole gradient alike from the same rows: a sum would multiply it by
  n_model.

Whole parameters (and the gathered leaves' compute) are replicated over
the model group. `gather_state_dict` / `scatter_state_dict` move between
the ranks' shards and the whole state, so checkpoints stay whole.

`COMM` counts the model axis's collectives (and their bytes) since
`reset_comm`; gloo has no reduce-scatter, so nothing here needs one.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from rvc_tpu_torch.parallel.mesh import MIN_SIZE, Axis, tp_dim

COMM = {"all_reduce": 0, "all_reduce_bytes": 0, "all_gather": 0, "all_gather_bytes": 0}


def reset_comm() -> None:
    for k in COMM:
        COMM[k] = 0


def all_reduce_model(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum `t` (contiguous) over the model group, in place; counted."""
    COMM["all_reduce"] += 1
    COMM["all_reduce_bytes"] += t.numel() * t.element_size()
    dist.all_reduce(t, group=axis.group)
    return t


def _all_gather(t: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(axis.size)]
    COMM["all_gather"] += 1
    COMM["all_gather_bytes"] += t.numel() * t.element_size() * axis.size
    dist.all_gather(parts, t, group=axis.group)
    return torch.cat(parts, dim)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_model(grad.contiguous().clone(), ctx.axis), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce_model(x.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherAtUse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, dim, axis):
        ctx.dim, ctx.axis, ctx.n = dim, axis, shard.shape[dim]
        return _all_gather(shard, dim, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.axis.index * ctx.n, ctx.n), None, None


def copy_to_model(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """x as it is; its gradient summed over the model group."""
    return x if axis is None or axis.size == 1 else _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The sum of x over the model group; the gradient passes as it is."""
    return x if axis is None or axis.size == 1 else _ReduceFromModel.apply(x, axis)


def gather_at_use(shard: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    """The whole tensor from every rank's slice along dim; the gradient
    keeps this rank's slice."""
    return _GatherAtUse.apply(shard, dim, axis)


def local_slice(t: torch.Tensor, dim: int, axis: Optional[Axis]) -> torch.Tensor:
    """This rank's 1/n of a whole tensor along dim, its gradient summed over
    the model group (a column-parallel layer's whole bias)."""
    if axis is None or axis.size == 1:
        return t
    n = t.shape[dim] // axis.size
    return copy_to_model(t, axis).narrow(dim, axis.index * n, n)


# ---------------------------------------------------------------------------
# laying the networks out
# ---------------------------------------------------------------------------

def shard_dim(p: torch.Tensor) -> Optional[int]:
    """The dimension parameter p holds a slice of over "model" (None: whole)."""
    return getattr(p, "tp_dim", None)


def whole_shape(p: torch.Tensor) -> Tuple[int, ...]:
    """Parameter p's shape before sharding."""
    return getattr(p, "tp_shape", tuple(p.shape))


def plan(net: torch.nn.Module, family: str, model_size: int,
         min_size: int = MIN_SIZE) -> Dict[str, Optional[int]]:
    """{parameter name: the torch dimension the reference's rule splits over
    "model", or None} for a whole network; family "synthesizer" or
    "discriminator" (`utils.weights.jax_layouts`)."""
    from rvc_tpu_torch.utils.weights import jax_layouts

    shapes = {k: tuple(p.shape) for k, p in net.named_parameters()}
    out = {}
    for k, (path, perm) in jax_layouts(shapes, family).items():
        out[k] = tp_dim(path, [shapes[k][i] for i in perm], perm, model_size, min_size)
    return out


def _gather_hooks(module: torch.nn.Module, leaves: Dict[str, int], axis: Axis) -> None:
    """The module's forward sees each leaf whole: gathered before, the shard
    put back after (also when the forward raises)."""
    shards = {}

    def before(mod, args):
        for name, dim in leaves.items():
            shards[name] = mod._parameters[name]
            mod._parameters[name] = gather_at_use(shards[name], dim, axis)

    def after(mod, args, out):
        mod._parameters.update(shards)
        shards.clear()

    module.register_forward_pre_hook(before)
    module.register_forward_hook(after, always_call=True)


def shard_module(net: torch.nn.Module, family: str, model: Axis,
                 min_size: int = MIN_SIZE) -> Dict[str, str]:
    """Lay one network out over the model axis (see the module's docstring);
    returns {parameter name: "pair" | "gathered"} for each split parameter."""
    dims = plan(net, family, model.size, min_size)
    params = dict(net.named_parameters())
    kinds: Dict[str, str] = {}
    for mname, mod in net.named_modules():
        members = mod.tp_pair(model.size) if hasattr(mod, "tp_pair") else None
        if members is None:
            continue
        col, row = ([f"{mname}.{n}" if mname else n for n in names] for names in members)
        if all(dims[n] == 0 for n in col) and all(dims[n] == 1 for n in row):
            mod.tp = model
            kinds.update((n, "pair") for n in col + row)
    gathered: Dict[str, Dict[str, int]] = {}
    for name, d in dims.items():
        if d is None:
            continue
        p = params[name]
        if shard_dim(p) is not None:
            raise ValueError(f"{name} is already sharded")
        whole = tuple(p.shape)
        n = whole[d] // model.size
        p.data = p.data.narrow(d, model.index * n, n).clone()
        p.tp_dim, p.tp_shape = d, whole
        if name not in kinds:
            kinds[name] = "gathered"
            owner, _, leaf = name.rpartition(".")
            gathered.setdefault(owner, {})[leaf] = d
    for owner, leaves in gathered.items():
        _gather_hooks(net.get_submodule(owner), leaves, model)
    return kinds


def shard_modules(net_g: torch.nn.Module, net_d: torch.nn.Module, model: Axis,
                  min_size: int = MIN_SIZE) -> Dict[str, str]:
    """G (a Synthesizer) and D (a MultiPeriodDiscriminator) laid out over
    the model axis; {"net_g.<name>" / "net_d.<name>": kind}."""
    kinds = {}
    for tag, net, family in (("net_g", net_g, "synthesizer"),
                             ("net_d", net_d, "discriminator")):
        kinds.update({f"{tag}.{k}": v for k, v in shard_module(net, family, model,
                                                               min_size).items()})
    return kinds


def gather_state_dict(net: torch.nn.Module, model: Axis) -> Dict[str, torch.Tensor]:
    """The network's whole state dict on every rank of the model group (a
    collective: every rank of the group calls it)."""
    dims = {k: shard_dim(p) for k, p in net.named_parameters()}
    out = {}
    for k, v in net.state_dict().items():
        d = dims.get(k)
        out[k] = v if d is None else _all_gather(v, d, model)
    return out


def scatter_state_dict(net: torch.nn.Module, state: Mapping[str, torch.Tensor],
                       model: Axis) -> None:
    """Load a whole state dict into the network's shards (no collective)."""
    dims = {k: shard_dim(p) for k, p in net.named_parameters()}
    own = {}
    for k, v in state.items():
        d = dims.get(k)
        if d is not None:
            n = v.shape[d] // model.size
            v = v.narrow(d, model.index * n, n)
        own[k] = v
    net.load_state_dict(own)

