"""K1 and K2: the decoder's ResBlock chains (wrappers of `csrc/resblock.cu`).

`resblock_group` replaces `rvc_tpu/ops/pallas/resblock.py :
fused_resblock_group` (K1, the mean over one decoder stage's parallel
ResBlocks); `resblock_chain` replaces `fused_resblock` (K2, one ResBlock
chain). Both launch the same CUDA kernel, one launch per dilation step,
and count their launches apart. For a CPU tensor each runs its plain
version (`resblock_group_reference`, `resblock_chain_reference`, the
reference's `_xla_resblock_group` / `_xla_resblock`); for a CUDA tensor
it launches the kernel or raises.

The kernel computes as the TPU kernel does: both convolutions take bf16
operands (the LReLU'd, boundary-zeroed input and the taps) on the tensor
cores and accumulate in float32; the biases, the residual and the stage
mean stay float32. The plain versions stay float32; `bf16_operands=True`
rounds their conv operands to bf16 at the kernel's places.

Weights take the reference's layout: w1/w2 (S, K, C, C) as (step, tap,
in, out), b1/b2 (S, C).

On the card both run under autograd (`ChainFunction`, `GroupFunction`):
the forward is the kernel; the backward re-runs the float32 plain version
from the saved inputs and takes its autograd (the reference's `_chain_bwd`
/ `_group_bwd`), so training's gradients are exact float32 ones of the
chain while the forward keeps the kernel's bf16 operands. The weights are
rounded to bf16 at every call (`kernel_weights`): in training they change
at every step.

**Tensor parallelism** (`parallel.tp`): on a rank of a model group of n,
a sharded ResBlock holds C_M = C / n of its mid channels: w1 (S, K, C, C_M)
column-parallel, b1 (S, C_M), w2 (S, K, C_M, C) row-parallel, b2 (S, C)
whole. `resblock_chain_tp` (K2's) and `resblock_group_tp` (K1's stage,
whose whole chains run K1 as before) launch the kernel's partial-sum
variant once per dilation step: it writes the rank's conv2 sum over all C
outputs; the rank of model index 0 adds the residual and b2 in its
epilogue, the others do not, so they enter the sum once; the model group
all-reduces the partial sums, and the next step reads the whole. The
stage mean is taken after the collective. The kernel takes (C, C_M) in
{(128, 64), (128, 32), (256, 128), (256, 64)} and raises on any other.
Their plain versions, `resblock_chain_partial_reference` and
`resblock_group_partial_reference`, compute the same with the
differentiable collectives (the residual and b2 added after the
all-reduce, on every rank); the backward of the card's launches
(`ChainTPFunction`, `GroupTPFunction`) re-runs them in float32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from rvc_tpu_torch.ops import conv as conv_ops
from rvc_tpu_torch.ops.kernels import build, count_launch, plain_vjp, recorded
from rvc_tpu_torch.parallel.mesh import Axis
from rvc_tpu_torch.parallel.tp import all_reduce_model, copy_to_model, reduce_from_model

CHANNELS = (32, 64, 128, 256)
TP_SHAPES = ((128, 64), (128, 32), (256, 128), (256, 64))     # (C, C_M) of the partial launch


def _lrelu(x: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(x > 0, x, slope * x)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def resblock_chain_reference(x, w1, b1, w2, b2, kernel_size: int,
                             dilations: Sequence[int] = (1, 3, 5), slope: float = 0.1,
                             bf16_operands: bool = False):
    """Plain version of K2: one ResBlock chain on (B, T, C).

    bf16_operands rounds both convs' inputs and weights to bf16 (the
    TPU kernel's and the CUDA kernel's operands); sums stay float32."""
    k = kernel_size
    op = _bf16 if bf16_operands else (lambda t: t)
    cur = x
    for s, d in enumerate(dilations):
        y = conv_ops.conv1d(op(_lrelu(cur, slope)), op(w1[s]), b1[s],
                            padding=(k * d - d) // 2, dilation=d)
        y = conv_ops.conv1d(op(_lrelu(y, slope)), op(w2[s]), b2[s], padding=(k - 1) // 2)
        cur = cur + y
    return cur


def resblock_group_reference(x, weights, kernel_sizes, dilations,
                             slope: float = 0.1, bf16_operands: bool = False):
    """Plain version of K1: mean of the stage's chains; weights is the flat
    (w1, b1, w2, b2) tuple of each chain in turn."""
    outs = [resblock_chain_reference(x, *weights[4 * i: 4 * i + 4],
                                     kernel_size=k, dilations=dilations[i],
                                     slope=slope, bf16_operands=bf16_operands)
            for i, k in enumerate(kernel_sizes)]
    return sum(outs) / len(outs)


def resblock_step_partial_reference(x, w1, b1, w2, b2, kernel_size: int, dilation: int,
                                    slope: float, residual: bool,
                                    bf16_operands: bool = False):
    """Plain version of one partial-sum launch: a rank's share of one
    dilation step on (B, T, C), conv2(lrelu(conv1(lrelu(x)) + b1)) over its
    C_M mid channels (w1 (K, C, C_M), b1 (C_M,), w2 (K, C_M, C)), plus
    x + b2 (b2 (C,)) where `residual`."""
    k, d = kernel_size, dilation
    op = _bf16 if bf16_operands else (lambda t: t)
    y = conv_ops.conv1d(op(_lrelu(x, slope)), op(w1), b1, padding=(k * d - d) // 2, dilation=d)
    y = conv_ops.conv1d(op(_lrelu(y, slope)), op(w2), None, padding=(k - 1) // 2)
    return y + x + b2 if residual else y


def resblock_chain_partial_reference(x, w1, b1, w2, b2, kernel_size: int,
                                     dilations: Sequence[int], slope: float, model: Axis,
                                     bf16_operands: bool = False):
    """Plain version of `resblock_chain_tp`: the ResBlock chain from a model
    group's rank shards, with the differentiable collectives. x enters each
    step through `copy_to_model`; the partial sums leave through
    `reduce_from_model`; the residual and b2 are added after it, on every
    rank (the same sum as the kernel's, whose rank 0 adds them)."""
    cur = x
    for s, d in enumerate(dilations):
        part = resblock_step_partial_reference(copy_to_model(cur, model), w1[s], b1[s], w2[s],
                                               b2[s], kernel_size, d, slope, False,
                                               bf16_operands)
        cur = reduce_from_model(part, model) + cur + b2[s]
    return cur


def _sharded(x: torch.Tensor, w1: torch.Tensor) -> bool:
    """Whether a chain's weights are a rank's shard (C_M < C)."""
    return w1.shape[-1] != x.shape[-1]


def resblock_group_partial_reference(x, weights, kernel_sizes, dilations, slope: float,
                                     model: Axis, bf16_operands: bool = False):
    """Plain version of `resblock_group_tp`: the stage's mean, whole chains
    as in `resblock_group_reference`, sharded ones (w1's last dimension
    C_M < C) as in `resblock_chain_partial_reference`."""
    outs = []
    for i, k in enumerate(kernel_sizes):
        w = weights[4 * i: 4 * i + 4]
        if _sharded(x, w[0]):
            outs.append(resblock_chain_partial_reference(x, *w, k, dilations[i], slope, model,
                                                         bf16_operands))
        else:
            outs.append(resblock_chain_reference(x, *w, kernel_size=k, dilations=dilations[i],
                                                 slope=slope, bf16_operands=bf16_operands))
    return sum(outs) / len(outs)


def kernel_weights(w: torch.Tensor) -> torch.Tensor:
    """(S, K, Cin, Cout) float32 -> (S, Cout, K, Cin) bf16, contiguous: per
    step, row n holds every tap's Cin weights of output channel n, the
    `.col` B operand of the kernel's mma."""
    return w.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous()


@functools.cache
def _lib():
    """The kernel's C entry, with its ctypes signature set once."""
    fn = build.load("resblock").rvc_resblock_step
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_float] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _lib_partial():
    """The partial-sum launch's C entry, with its ctypes signature set once."""
    fn = build.load("resblock").rvc_resblock_step_partial
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                                                  ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, tensors, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 3 or x.shape[2] not in CHANNELS:
        raise ValueError(f"{name}: want (B, T, C) float32 with C in {CHANNELS}, "
                         f"got {tuple(x.shape)} {x.dtype}")
    for t in tensors:
        if t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"{name}: weights must be float32 on {x.device}")


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x contiguous at a 16-byte address (the kernel reads float4 rows)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _run_chain(x, w1, b1, w2, b2, kernel_size, dilations, slope, out, alpha,
               beta, counter: str) -> None:
    """Launch the chain's steps; the last writes alpha * chain + beta * out."""
    B, T, C = x.shape
    K = kernel_size
    if K % 2 == 0 or w1.shape[1:] != (K, C, C) or w2.shape[1:] != (K, C, C):
        raise ValueError(f"{counter}: weights {tuple(w1.shape)} do not match "
                         f"kernel {K} and C={C}")
    fn = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    w1, w2 = kernel_weights(w1), kernel_weights(w2)
    b1, b2 = b1.contiguous(), b2.contiguous()
    tmp = [torch.empty_like(x), torch.empty_like(x)]
    cur = x
    for s, d in enumerate(dilations):
        last = s == len(dilations) - 1
        dst = out if last else tmp[s % 2]
        err = fn(cur.data_ptr(), dst.data_ptr(), w1[s].data_ptr(), b1[s].data_ptr(),
                 w2[s].data_ptr(), b2[s].data_ptr(), B, T, C, K, d, slope,
                 alpha if last else 1.0, beta if last else 0.0, stream)
        build.check(err, counter)
        count_launch(counter)
        cur = dst


def _launch_chain(x, w1, b1, w2, b2, kernel_size: int, dilations: Sequence[int],
                  slope: float) -> torch.Tensor:
    """K2's launches on CUDA tensors (the forward of `ChainFunction`)."""
    _check(x, (w1, b1, w2, b2), "resblock_chain")
    x = _aligned(x)
    out = torch.empty_like(x)
    _run_chain(x, w1, b1, w2, b2, kernel_size, dilations, slope, out, 1.0, 0.0,
               "resblock_chain")
    return out


def _launch_group(x, weights, kernel_sizes: Sequence[int],
                  dilations: Sequence[Sequence[int]], slope: float) -> torch.Tensor:
    """K1's launches on CUDA tensors (the forward of `GroupFunction`)."""
    _check(x, weights, "resblock_group")
    x = _aligned(x)
    out = torch.empty_like(x)
    n = len(kernel_sizes)
    for i, k in enumerate(kernel_sizes):
        _run_chain(x, *weights[4 * i: 4 * i + 4], kernel_size=k,
                   dilations=dilations[i], slope=slope, out=out, alpha=1.0 / n,
                   beta=0.0 if i == 0 else 1.0, counter="resblock_group")
    return out


def _run_chain_tp(x, w1, b1, w2, b2, kernel_size, dilations, slope, model: Axis,
                  counter: str) -> torch.Tensor:
    """A sharded chain's partial-sum launches, one per dilation step, each
    followed by the model group's all-reduce; returns the whole chain."""
    B, T, C = x.shape
    K, CM = kernel_size, w1.shape[-1]
    if (C, CM) not in TP_SHAPES or w1.shape[1:] != (K, C, CM) or w2.shape[1:] != (K, CM, C) \
            or b1.shape[1:] != (CM,) or b2.shape[1:] != (C,):
        raise ValueError(f"{counter}: the partial launch takes (C, C_M) in {TP_SHAPES} and "
                         f"w1 (S, K, C, C_M), w2 (S, K, C_M, C); got C={C}, w1 "
                         f"{tuple(w1.shape)}, w2 {tuple(w2.shape)}, kernel {K}")
    fn = _lib_partial()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    w1, w2 = kernel_weights(w1), kernel_weights(w2)
    b1, b2 = b1.contiguous(), b2.contiguous()
    residual = int(model.index == 0)
    cur = x
    for s, d in enumerate(dilations):
        part = torch.empty_like(x)
        err = fn(cur.data_ptr(), part.data_ptr(), w1[s].data_ptr(), b1[s].data_ptr(),
                 w2[s].data_ptr(), b2[s].data_ptr(), B, T, C, CM, K, d, slope, residual, stream)
        build.check(err, counter)
        count_launch(counter)
        cur = all_reduce_model(part, model)
    return cur


def _launch_chain_tp(x, w1, b1, w2, b2, kernel_size: int, dilations: Sequence[int],
                     slope: float, model: Axis) -> torch.Tensor:
    """K2's partial-sum launches on CUDA tensors (the forward of
    `ChainTPFunction`)."""
    _check(x, (w1, b1, w2, b2), "resblock_chain_tp")
    return _run_chain_tp(_aligned(x), w1, b1, w2, b2, kernel_size, dilations, slope, model,
                         "resblock_chain_tp")


def _launch_group_tp(x, weights, kernel_sizes: Sequence[int],
                     dilations: Sequence[Sequence[int]], slope: float,
                     model: Axis) -> torch.Tensor:
    """A K1 stage on a tensor-parallel rank (the forward of `GroupTPFunction`):
    the whole chains by K1's launches (alpha 1 / n, accumulated), then each
    sharded chain by the partial-sum launches, added / n after its last
    all-reduce."""
    _check(x, weights, "resblock_group_tp")
    x = _aligned(x)
    out = torch.empty_like(x)
    n = len(kernel_sizes)
    first = True
    for i, k in enumerate(kernel_sizes):
        w = weights[4 * i: 4 * i + 4]
        if not _sharded(x, w[0]):
            _run_chain(x, *w, kernel_size=k, dilations=dilations[i], slope=slope, out=out,
                       alpha=1.0 / n, beta=0.0 if first else 1.0, counter="resblock_group")
            first = False
    for i, k in enumerate(kernel_sizes):
        w = weights[4 * i: 4 * i + 4]
        if _sharded(x, w[0]):
            chain = _run_chain_tp(x, *w, k, dilations[i], slope, model, "resblock_group_tp")
            if first:
                torch.mul(chain, 1.0 / n, out=out)
                first = False
            else:
                out.add_(chain, alpha=1.0 / n)
    return out


class ChainFunction(torch.autograd.Function):
    """K2 under autograd: `forward` (the kernel's launches; any callable
    with `resblock_chain_reference`'s signature) computes the output, the
    float32 plain chain's autograd the gradients of x, w1, b1, w2, b2."""

    @staticmethod
    def forward(ctx, forward, kernel_size, dilations, slope, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        ctx.args = (kernel_size, dilations, slope)
        return forward(x, w1, b1, w2, b2, kernel_size, dilations, slope)

    @staticmethod
    def backward(ctx, grad):
        k, d, slope = ctx.args
        grads = plain_vjp(lambda *t: resblock_chain_reference(*t, k, d, slope),
                          ctx.saved_tensors, ctx.needs_input_grad[4:], grad)
        return (None,) * 4 + grads


class GroupFunction(torch.autograd.Function):
    """K1 under autograd: `forward` (the kernel's launches; any callable with
    `resblock_group_reference`'s signature) computes the output, the float32
    plain stage's autograd the gradients of x and of each tensor of the flat
    weight tuple, in order."""

    @staticmethod
    def forward(ctx, forward, kernel_sizes, dilations, slope, x, *weights):
        ctx.save_for_backward(x, *weights)
        ctx.args = (kernel_sizes, dilations, slope)
        return forward(x, weights, kernel_sizes, dilations, slope)

    @staticmethod
    def backward(ctx, grad):
        ks, ds, slope = ctx.args
        grads = plain_vjp(lambda x, *w: resblock_group_reference(x, w, ks, ds, slope),
                          ctx.saved_tensors, ctx.needs_input_grad[4:], grad)
        return (None,) * 4 + grads


@recorded
def resblock_chain(x: torch.Tensor, w1, b1, w2, b2, kernel_size: int,
                   dilations: Sequence[int] = (1, 3, 5),
                   slope: float = 0.1) -> torch.Tensor:
    """K2: one ResBlock chain on (B, T, C) float32."""
    if x.device.type == "cpu":
        return resblock_chain_reference(x, w1, b1, w2, b2, kernel_size,
                                        dilations, slope)
    return ChainFunction.apply(_launch_chain, kernel_size, tuple(dilations), slope,
                               x, w1, b1, w2, b2)


@recorded
def resblock_group(x: torch.Tensor, weights: tuple, kernel_sizes: Sequence[int],
                   dilations: Sequence[Sequence[int]],
                   slope: float = 0.1) -> torch.Tensor:
    """K1: mean over one decoder stage's parallel ResBlock chains."""
    if x.device.type == "cpu":
        return resblock_group_reference(x, weights, kernel_sizes, dilations, slope)
    return GroupFunction.apply(_launch_group, tuple(kernel_sizes),
                               tuple(tuple(d) for d in dilations), slope, x, *weights)


class ChainTPFunction(torch.autograd.Function):
    """The partial-sum chain under autograd: `forward` (the launches and
    all-reduces; any callable with `resblock_chain_partial_reference`'s
    signature) computes the whole chain, the float32 plain partial chain's
    autograd, collectives included, the gradients of x (whole), w1, b1, w2
    (the rank's shards) and b2 (whole)."""

    @staticmethod
    def forward(ctx, forward, kernel_size, dilations, slope, model, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        ctx.args = (kernel_size, dilations, slope, model)
        return forward(x, w1, b1, w2, b2, kernel_size, dilations, slope, model)

    @staticmethod
    def backward(ctx, grad):
        k, d, slope, model = ctx.args
        grads = plain_vjp(lambda *t: resblock_chain_partial_reference(*t, k, d, slope, model),
                          ctx.saved_tensors, ctx.needs_input_grad[5:], grad)
        return (None,) * 5 + grads


class GroupTPFunction(torch.autograd.Function):
    """A K1 stage on a tensor-parallel rank under autograd, as
    `GroupFunction` with `resblock_group_partial_reference` for the
    backward."""

    @staticmethod
    def forward(ctx, forward, kernel_sizes, dilations, slope, model, x, *weights):
        ctx.save_for_backward(x, *weights)
        ctx.args = (kernel_sizes, dilations, slope, model)
        return forward(x, weights, kernel_sizes, dilations, slope, model)

    @staticmethod
    def backward(ctx, grad):
        ks, ds, slope, model = ctx.args
        grads = plain_vjp(
            lambda x, *w: resblock_group_partial_reference(x, w, ks, ds, slope, model),
            ctx.saved_tensors, ctx.needs_input_grad[5:], grad)
        return (None,) * 5 + grads


@recorded
def resblock_chain_tp(x: torch.Tensor, w1, b1, w2, b2, kernel_size: int,
                      dilations: Sequence[int], slope: float, model: Axis) -> torch.Tensor:
    """K2 on a tensor-parallel rank: one ResBlock chain on (B, T, C) float32
    from the rank's shards (see the module's docstring)."""
    if x.device.type == "cpu":
        return resblock_chain_partial_reference(x, w1, b1, w2, b2, kernel_size, dilations,
                                                slope, model)
    return ChainTPFunction.apply(_launch_chain_tp, kernel_size, tuple(dilations), slope, model,
                                 x, w1, b1, w2, b2)


@recorded
def resblock_group_tp(x: torch.Tensor, weights: tuple, kernel_sizes: Sequence[int],
                      dilations: Sequence[Sequence[int]], slope: float,
                      model: Axis) -> torch.Tensor:
    """K1 on a tensor-parallel rank: the mean over one decoder stage's
    chains, the sharded ones (C_M < C) by the partial-sum launches."""
    if x.device.type == "cpu":
        return resblock_group_partial_reference(x, weights, kernel_sizes, dilations, slope,
                                                model)
    return GroupTPFunction.apply(_launch_group_tp, tuple(kernel_sizes),
                                 tuple(tuple(d) for d in dilations), slope, model, x, *weights)
