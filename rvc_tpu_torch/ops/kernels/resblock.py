"""K1 and K2: the decoder's ResBlock chains (wrappers of `csrc/resblock.cu`).

`resblock_group` replaces `rvc_tpu/ops/pallas/resblock.py :
fused_resblock_group` (K1, the mean over one decoder stage's parallel
ResBlocks); `resblock_chain` replaces `fused_resblock` (K2, one ResBlock
chain). Both launch the same CUDA kernel (`rvc_resblock_chains`) and count
their launches apart. For a CPU tensor each runs its plain version
(`resblock_group_reference`, `resblock_chain_reference`, the reference's
`_xla_resblock_group` / `_xla_resblock`); for a CUDA tensor it launches
the kernel or raises.

The kernel computes as the TPU kernel does: both convolutions take bf16
operands (the LReLU'd, boundary-zeroed input and the taps) on the tensor
cores and accumulate in float32; the biases, the residual and the stage
mean stay float32. The plain versions stay float32; `bf16_operands=True`
rounds their conv operands to bf16 at the kernel's places.

**The launch plan** (`launch_plan`, pure Python; the kernel checks it): at
C <= 128 one launch runs a whole call, every chain and every dilation step,
as the TPU kernel's single pass: a block reads its time tile plus a halo
(the largest receptive field over the call's chains) once and keeps the
float32 residual on chip. At C = 256, where such a window does not fit a
block's shared memory, the kernel runs one launch per dilation step.
`resblock_group_tiled_reference` runs the plain chains tile by tile on the
plan's windows, with the boundary zeroing, and stitches the tiles: the
plan's arithmetic, on the CPU.

Weights take the reference's layout: w1/w2 (S, K, C, C) as (step, tap,
in, out), b1/b2 (S, C). The kernel reads them as 64-column bf16 chunks in
wgmma's swizzled layout (`tma_weights`), all of a call's convs in the
order it uses them (`stage_buffers`). That conversion is cached per weight
version (`cached`: keyed on the tensors and their in-place `_version`), so
inference converts once and training again after each optimizer step;
`ResBlock.stacked_weights` keeps its stacked tensors under no-grad for the
same reason. `drop_cached` forgets a model's entries.

On the card both run under autograd (`ChainFunction`, `GroupFunction`):
the forward is the kernel; the backward re-runs the float32 plain version
from the saved inputs and takes its autograd (the reference's `_chain_bwd`
/ `_group_bwd`), so training's gradients are exact float32 ones of the
chain while the forward keeps the kernel's bf16 operands.

**Tensor parallelism** (`parallel.tp`): on a rank of a model group of n,
a sharded ResBlock holds C_M = C / n of its mid channels: w1 (S, K, C, C_M)
column-parallel, b1 (S, C_M), w2 (S, K, C_M, C) row-parallel, b2 (S, C)
whole. `resblock_chain_tp` (K2's) and `resblock_group_tp` (K1's stage,
whose whole chains run K1's launch as before) launch the per-step
kernel's partial-sum variant (`rvc_resblock_step_partial`) once per
dilation step: it writes the rank's conv2 sum over all C outputs; the rank
of model index 0 adds the residual and b2 in its epilogue, the others do
not, so they enter the sum once; the model group all-reduces the partial
sums, and the next step reads the whole. The stage mean is taken after the
collective. The kernel takes (C, C_M) in {(128, 64), (128, 32), (256, 128),
(256, 64)} and raises on any other. Their plain versions,
`resblock_chain_partial_reference` and `resblock_group_partial_reference`,
compute the same with the differentiable collectives (the residual and b2
added after the all-reduce, on every rank); the backward of the card's
launches (`ChainTPFunction`, `GroupTPFunction`) re-runs them in float32.

**The per-step yardstick** (`resblock_group_per_step`,
`resblock_chain_per_step`): the same function by the per-step kernel's
(C, C) instance (`rvc_resblock_step`), one launch per dilation step, as
K1/K2 ran before the one-pass design. No path calls them and they count
no launches: `chip_smoke.py` times them beside K1/K2 on the same inputs.

**The packed lane layout** (`resblock_group_packed`, the counterpart of
`rvc_tpu/ops/pallas/resblock.py : resblock_group_packed`): a K1 stage whose
x arrives as (B, R, P * C), P = 128 // C consecutive time steps in each
row, with `t_valid` = T <= R * P true steps. It unfolds x to (B, R * P, C),
runs K1 on the first T steps (the kernel's zero boundary is the
reference's validity mask at `packed_t`), and folds the result back, with
zeros past T. Its launches count apart (`resblock_group_packed`); its
backward (`GroupPackedFunction`) unfolds, takes the plain stage's autograd
and refolds, as the reference's `_group_packed_bwd`.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
import weakref
from typing import Callable, Dict, Sequence

import torch
from torch.nn import functional as F

from rvc_tpu_torch.ops import conv as conv_ops
from rvc_tpu_torch.ops.kernels import CONVERSIONS, build, count_launch, plain_vjp, recorded
from rvc_tpu_torch.parallel.mesh import Axis
from rvc_tpu_torch.parallel.tp import all_reduce_model, copy_to_model, reduce_from_model
from rvc_tpu_torch.utils.profiling import trace_span

CHANNELS = (32, 64, 128, 256)
TP_SHAPES = ((128, 64), (128, 32), (256, 128), (256, 64))     # (C, C_M) of the partial launch
LANES = 128                      # the packed layout's row: P = LANES // C time steps of C channels

# The one-pass kernel's plan (csrc/resblock.cu, namespace wg): a block of 384
# threads, two warpgroups of MT 64-row tiles each; weight chunks of 64 k-columns.
THREADS = 384
TILES = {256: 1, 128: 2, 64: 3, 32: 5}      # MT: 64-row tiles a warpgroup holds
ONE_PASS_TILE = {32: 512, 64: 256, 128: 128}  # the largest output tile a block, one-pass
CHUNK_K = 64
MAX_STAGES = 4                   # weight chunks in flight (the kernel reserves 8 slots)
MAX_CHAINS = 4
MAX_STEPS = 8
SMEM_LIMIT = 232448              # H100: 227 KB of shared memory a block
SMS = 132


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


def _check_packed(x: torch.Tensor, channels: int, t_valid: int) -> None:
    """Raise unless x is packed (B, R, P * C) at C = channels in (128, 64,
    32), P = 128 // C, holding 0 < t_valid <= R * P steps."""
    if channels not in CHANNELS[:3]:
        raise ValueError(f"resblock_group_packed: channels {channels} not in {CHANNELS[:3]}")
    P = LANES // channels
    if x.dim() != 3 or x.shape[2] != P * channels or not 0 < t_valid <= x.shape[1] * P:
        raise ValueError(f"resblock_group_packed: want (B, R, {P * channels}) holding "
                         f"{t_valid} <= R * {P} steps, got {tuple(x.shape)}")


def _unfold(x: torch.Tensor, channels: int, t_valid: int) -> torch.Tensor:
    """Packed (B, R, P * C) -> its first t_valid steps (B, t_valid, C)."""
    return x.reshape(x.shape[0], -1, channels)[:, :t_valid]


def _fold(y: torch.Tensor, rows: int) -> torch.Tensor:
    """(B, T, C) -> packed (B, rows, P * C), zeros past T."""
    B, T, C = y.shape
    P = LANES // C
    if rows * P > T:
        y = F.pad(y, (0, 0, 0, rows * P - T))
    return y.reshape(B, rows, P * C)


def resblock_group_packed_reference(x, weights, kernel_sizes, dilations, channels: int,
                                    t_valid: int, slope: float = 0.1,
                                    bf16_operands: bool = False):
    """Plain version of `resblock_group_packed`: `resblock_group_reference`
    on the unfolded first t_valid steps, folded back."""
    _check_packed(x, channels, t_valid)
    y = resblock_group_reference(_unfold(x, channels, t_valid), weights, kernel_sizes,
                                 dilations, slope, bf16_operands)
    return _fold(y, x.shape[1])


def chain_halo(kernel_size: int, dilations: Sequence[int]) -> int:
    """A chain's receptive field on each side: the rows its output depends on
    beyond its own, sum over steps of (k - 1) / 2 * d + (k - 1) / 2."""
    h = (kernel_size - 1) // 2
    return sum(h * d + h for d in dilations)


def _smem(C: int, stages: int, rows_a: int, one_pass: bool) -> int:
    """Shared bytes of a launch (the kernel's `smem_bytes`): the 1024-byte
    alignment, the weight ring, 8 mbarrier pairs, the bf16 A (and Bf) plane
    of rows_a rows padded by 16 bytes, and one-pass the float32 residual
    window, padded likewise."""
    return (1024 + stages * CHUNK_K * C * 2 + 16 * 8 + rows_a * (C + 8) * 2
            + (rows_a * (C + 4) * 4 if one_pass else 0))


def _stages(C: int, rows_a: int, one_pass: bool) -> int:
    """The deepest ring (2 .. MAX_STAGES) that fits, or 0."""
    for stages in range(MAX_STAGES, 1, -1):
        if _smem(C, stages, rows_a, one_pass) <= SMEM_LIMIT:
            return stages
    return 0


def launch_plan(C: int, T: int, kernel_sizes: Sequence[int],
                dilations: Sequence[Sequence[int]], batch: int = 1) -> dict:
    """The launches of one K1 call (K2: one chain) on (batch, T, C).

    C <= 128, one-pass: one launch; output tile `tile` rows, `halo` = the
    largest receptive field over the chains, the window tile + 2 halo rows,
    each chain's first conv on at most the 128 x MT rows two warpgroups
    hold. C = 256, step mode: per chain a tile of 128 - (k - 1) rows and
    one launch per dilation step (`tiles`, one per chain; `halo` the
    largest step's reach); `smem_bytes` is the largest over the launches,
    `stages` the smallest; `blocks` sums the launches' blocks. Raises where
    the window or a step does not fit a block."""
    if C not in CHANNELS:
        raise ValueError(f"resblock: C={C} not in {CHANNELS}")
    chains = [(int(k), tuple(int(d) for d in ds)) for k, ds in zip(kernel_sizes, dilations)]
    if not 0 < len(chains) <= MAX_CHAINS or any(
            k % 2 == 0 or not 0 < len(ds) <= MAX_STEPS or min(ds) < 1 for k, ds in chains):
        raise ValueError(f"resblock: chains {chains} not taken (odd k, 1..{MAX_STEPS} "
                         f"dilations >= 1, 1..{MAX_CHAINS} chains)")
    cap = 128 * TILES[C]
    halo = max(chain_halo(k, ds) for k, ds in chains)
    if C in ONE_PASS_TILE:
        tile = min(ONE_PASS_TILE[C],
                   min(cap - 2 * chain_halo(k, ds) + 2 * ((k - 1) // 2) * ds[0]
                       for k, ds in chains))
        rows = tile + 2 * halo
        stages = _stages(C, rows, True) if tile >= 64 else 0
        if not stages:
            raise ValueError(f"resblock: C={C}, halo {halo}: the window does not fit a block")
        blocks = batch * math.ceil(T / tile)
        return dict(mode="one_pass", C=C, T=T, tile=tile, halo=halo, window=rows,
                    stages=stages, smem_bytes=_smem(C, stages, rows, True), threads=THREADS,
                    blocks=blocks, launches=1, waves=blocks / SMS)
    tiles, smem, stages_all, blocks, launches = [], 0, [], 0, 0
    for k, ds in chains:
        h2 = (k - 1) // 2
        tile = cap - 2 * h2
        rows_a = cap + (k - 1) * max(ds)
        stages = _stages(C, rows_a, False)
        if not stages or tile < 64:
            raise ValueError(f"resblock: no plan for C={C}, k={k}, dilations {ds}")
        tiles.append(tile)
        smem = max(smem, _smem(C, stages, rows_a, False))
        stages_all.append(stages)
        blocks += batch * math.ceil(T / tile) * len(ds)
        launches += len(ds)
    return dict(mode="step", C=C, T=T, tile=min(tiles), tiles=tiles,
                halo=max((k - 1) // 2 * (max(ds) + 1) for k, ds in chains),
                stages=min(stages_all), smem_bytes=smem,
                threads=THREADS, blocks=blocks, launches=launches,
                waves=blocks / launches / SMS)


_plan = functools.lru_cache(maxsize=256)(launch_plan)     # the wrappers' plans, by shape


def _masked_step(x, mask, w1, b1, w2, b2, k: int, d: int, slope: float, op):
    """One dilation step on windows x (N, W, C) whose rows outside [0, T)
    are zero in `mask` (N, W, 1): every conv input is zeroed there."""
    y = conv_ops.conv1d(op(_lrelu(x, slope) * mask), op(w1), b1,
                        padding=(k * d - d) // 2, dilation=d)
    y = conv_ops.conv1d(op(_lrelu(y, slope) * mask), op(w2), b2, padding=(k - 1) // 2)
    return x + y


def _windows(x: torch.Tensor, tile: int, halo: int):
    """x (B, T, C) -> the (B * n, tile + 2 halo, C) windows of its n time
    tiles (zeros outside [0, T)) and their (B * n, W, 1) validity mask."""
    B, T, C = x.shape
    n = math.ceil(T / tile)
    W = tile + 2 * halo
    xp = F.pad(x, (0, 0, halo, n * tile + halo - T))
    win = xp.unfold(1, W, tile).permute(0, 1, 3, 2).reshape(B * n, W, C)
    t = torch.arange(n, device=x.device)[:, None] * tile - halo + torch.arange(W, device=x.device)
    mask = ((t >= 0) & (t < T)).to(x.dtype)[None, :, :, None].expand(B, n, W, 1)
    return win, mask.reshape(B * n, W, 1)


def _stitch(y: torch.Tensor, B: int, T: int, tile: int, halo: int) -> torch.Tensor:
    """The tiles' own rows of windows y (B * n, W, C), stitched to (B, T, C)."""
    C = y.shape[-1]
    return y[:, halo:halo + tile].reshape(B, -1, C)[:, :T]


def resblock_group_tiled_reference(x, weights, kernel_sizes, dilations,
                                   slope: float = 0.1, bf16_operands: bool = False):
    """`resblock_group_reference` computed as `launch_plan` tiles it: one-pass,
    every chain on each tile's window of tile + 2 halo rows, each conv
    input zero outside [0, T), the mean, the tile's own rows stitched; step
    mode, each dilation step on its own windows (halo (k - 1) / 2 (d + 1)).
    Equal to the untiled plain version wherever the halo covers the
    receptive field (float32)."""
    B, T, C = x.shape
    plan = launch_plan(C, T, kernel_sizes, dilations, B)
    op = _bf16 if bf16_operands else (lambda t: t)
    outs = []
    if plan["mode"] == "one_pass":
        tile, halo = plan["tile"], plan["halo"]
        win, mask = _windows(x, tile, halo)
        for i, k in enumerate(kernel_sizes):
            w1, b1, w2, b2 = weights[4 * i: 4 * i + 4]
            cur = win
            for s, d in enumerate(dilations[i]):
                cur = _masked_step(cur, mask, w1[s], b1[s], w2[s], b2[s], k, d, slope, op)
            outs.append(_stitch(cur, B, T, tile, halo))
    else:
        for i, k in enumerate(kernel_sizes):
            w1, b1, w2, b2 = weights[4 * i: 4 * i + 4]
            tile, cur = plan["tiles"][i], x
            for s, d in enumerate(dilations[i]):
                halo = (k - 1) // 2 * (d + 1)
                win, mask = _windows(cur, tile, halo)
                win = _masked_step(win, mask, w1[s], b1[s], w2[s], b2[s], k, d, slope, op)
                cur = _stitch(win, B, T, tile, halo)
            outs.append(cur)
    return sum(outs) / len(outs)


def kernel_weights(w: torch.Tensor) -> torch.Tensor:
    """(S, K, Cin, Cout) float32 -> (S, Cout, K, Cin) bf16, contiguous: per
    step, row n holds every tap's Cin weights of output channel n, the
    `.col` B operand of the per-step kernel's mma."""
    return w.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous()


def tma_weights(w: torch.Tensor) -> torch.Tensor:
    """(S, K, Cin, Cout) float32 -> (S, n, Cout, 64) bf16, contiguous: per
    step, `kernel_weights`' (Cout, K * Cin) matrix zero-padded to n = ceil(K
    * Cin / 64) chunks of 64 columns, each chunk Cout rows of 128 bytes in
    the 128-byte swizzle (16-byte unit u of row r stored at u ^ (r % 8)),
    the layout wgmma reads its B operand in and a bulk copy lands as is."""
    S, K, Cin, Cout = w.shape
    m = kernel_weights(w).reshape(S, Cout, K * Cin)
    n = -(-K * Cin // CHUNK_K)
    m = F.pad(m, (0, n * CHUNK_K - K * Cin)).reshape(S, Cout, n, 8, 8).permute(0, 2, 1, 3, 4)
    rows = torch.arange(Cout, device=w.device)
    src = torch.arange(8, device=w.device)[None, :] ^ (rows[:, None] % 8)   # (Cout, 8)
    return torch.gather(m, 3, src[None, None, :, :, None].expand(S, n, Cout, 8, 8)) \
        .reshape(S, n, Cout, CHUNK_K).contiguous()


# converted weights, keyed on (tag, the source tensors' ids): (weak refs to the
# sources, their _version at conversion, the result)
_CACHE: Dict[tuple, tuple] = {}
_cache_lock = threading.Lock()


def cached(tag: str, tensors: Sequence[torch.Tensor], make: Callable[[], object]):
    """make(), converted once per version of `tensors`: the same result while
    every tensor is the same object with the same `_version` (an in-place
    update, an optimizer step, bumps it), else made anew. An entry is
    dropped when a source tensor is freed. Inference tensors have no
    version, so their results are never kept. Each make() counts in
    `CONVERSIONS[tag]` and is the span kernels/convert_weights."""
    if any(t.is_inference() for t in tensors):
        return _convert(tag, make)
    key = (tag,) + tuple(id(t) for t in tensors)
    versions = tuple(t._version for t in tensors)
    with _cache_lock:
        hit = _CACHE.get(key)
    if hit is not None and hit[1] == versions and all(r() is t for r, t in zip(hit[0], tensors)):
        return hit[2]
    value = _convert(tag, make)

    def forget(_, key=key):
        with _cache_lock:
            _CACHE.pop(key, None)

    with _cache_lock:
        _CACHE[key] = (tuple(weakref.ref(t, forget) for t in tensors), versions, value)
    return value


def _convert(tag: str, make: Callable[[], object]):
    count_launch(tag, CONVERSIONS)
    with trace_span("kernels/convert_weights"):
        return make()


def drop_cached(tensors: Sequence[torch.Tensor]) -> int:
    """Forget every cached conversion made from any of `tensors`; returns the
    entries dropped."""
    ids = {id(t) for t in tensors}
    with _cache_lock:
        keys = [k for k in _CACHE if ids.intersection(k[1:])]
        for k in keys:
            del _CACHE[k]
    return len(keys)


def _step_weights(w: torch.Tensor) -> torch.Tensor:
    """`kernel_weights(w)` for the per-step kernel, once per weight version."""
    return cached("step", (w,), lambda: kernel_weights(w))


def stage_buffers(weights: Sequence[torch.Tensor]):
    """(chunks, biases) of one call, converted once per weight version: every
    chain's conv1 then conv2 chunks of each step in order (`tma_weights`,
    flat bf16), and b1 then b2 of each step (flat float32)."""
    def make():
        chunks, biases = [], []
        for i in range(0, len(weights), 4):
            w1, b1, w2, b2 = weights[i: i + 4]
            chunks.append(torch.stack([tma_weights(w1), tma_weights(w2)], 1).reshape(-1))
            biases.append(torch.stack([b1, b2], 1).reshape(-1))
        return torch.cat(chunks), torch.cat(biases).float().contiguous()
    return cached("stage", weights, make)


@functools.cache
def _lib():
    """The per-step kernel's C entry, with its ctypes signature set once."""
    fn = build.load("resblock").rvc_resblock_step
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_float] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _lib_chains():
    """The one-pass kernel's C entry, with its ctypes signature set once."""
    fn = build.load("resblock").rvc_resblock_chains
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p] * 3 + [
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


def _check_chains(x: torch.Tensor, weights, kernel_sizes, dilations, name: str) -> None:
    """Raise unless each chain's weights are (S, K, C, C) / (S, C) for its
    kernel size and S dilations."""
    C = x.shape[2]
    if len(weights) != 4 * len(kernel_sizes) or len(dilations) != len(kernel_sizes):
        raise ValueError(f"{name}: {len(weights)} weights for {len(kernel_sizes)} chains")
    for i, (k, ds) in enumerate(zip(kernel_sizes, dilations)):
        w1, b1, w2, b2 = weights[4 * i: 4 * i + 4]
        S = len(ds)
        if k % 2 == 0 or w1.shape != (S, k, C, C) or w2.shape != (S, k, C, C) \
                or b1.shape != (S, C) or b2.shape != (S, C):
            raise ValueError(f"{name}: weights {tuple(w1.shape)} do not match kernel {k}, "
                             f"{S} dilations and C={C}")


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x contiguous at a 16-byte address (the kernel reads float4 rows)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _ints(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*values)


def _launch_chains(x, weights, kernel_sizes, dilations, slope: float, out: torch.Tensor,
                   alpha: float, beta: float, counter: str) -> None:
    """One call's launches by `launch_plan`: out = alpha * chain_0 + beta * out
    + alpha * (chain_1 + ...) (beta == 0 never reads out)."""
    B, T, C = x.shape
    _check_chains(x, weights, kernel_sizes, dilations, counter)
    plan = _plan(C, T, tuple(kernel_sizes), tuple(tuple(d) for d in dilations), B)
    chunks, biases = stage_buffers(weights)
    fn = _lib_chains()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    chunk_bytes = CHUNK_K * C * 2
    nch = [-(-k * C // CHUNK_K) for k in kernel_sizes]

    def launch(src, dst, w_ptr, b_ptr, one_pass, tile, ks, ds, nq, a, b):
        dils = [d for chain in ds for d in tuple(chain) + (1,) * (MAX_STEPS - len(chain))]
        err = fn(src.data_ptr(), dst.data_ptr(), w_ptr, b_ptr, B, T, C, int(one_pass), tile,
                 plan["halo"] if one_pass else 0, plan["stages"], plan["smem_bytes"], nq,
                 len(ks), _ints(ks), _ints([len(d) for d in ds]), _ints(dils), slope, a, b,
                 stream)
        build.check(err, counter)
        count_launch(counter)

    if plan["mode"] == "one_pass":
        nq = sum(2 * len(ds) * n for ds, n in zip(dilations, nch))
        launch(x, out, chunks.data_ptr(), biases.data_ptr(), True, plan["tile"],
               list(kernel_sizes), list(dilations), nq, alpha, beta)
        return
    tmp = [torch.empty_like(x), torch.empty_like(x)]
    q = bias = 0
    for i, (k, ds) in enumerate(zip(kernel_sizes, dilations)):
        cur = x
        for s, d in enumerate(ds):
            last = s == len(ds) - 1
            dst = out if last else tmp[s % 2]
            launch(cur, dst, chunks.data_ptr() + q * chunk_bytes, biases.data_ptr() + 4 * bias,
                   False, plan["tiles"][i], [k], [(d,)], 2 * nch[i],
                   alpha if last else 1.0, (beta if i == 0 else 1.0) if last else 0.0)
            q += 2 * nch[i]
            bias += 2 * C
            cur = dst


def _launch_chain(x, w1, b1, w2, b2, kernel_size: int, dilations: Sequence[int],
                  slope: float) -> torch.Tensor:
    """K2's launches on CUDA tensors (the forward of `ChainFunction`)."""
    _check(x, (w1, b1, w2, b2), "resblock_chain")
    x = _aligned(x)
    out = torch.empty_like(x)
    _launch_chains(x, (w1, b1, w2, b2), (kernel_size,), (tuple(dilations),), slope, out,
                   1.0, 0.0, "resblock_chain")
    return out


def _launch_group(x, weights, kernel_sizes: Sequence[int],
                  dilations: Sequence[Sequence[int]], slope: float,
                  counter: str = "resblock_group") -> torch.Tensor:
    """K1's launches on CUDA tensors (the forward of `GroupFunction`),
    counted under `counter`."""
    _check(x, weights, counter)
    x = _aligned(x)
    out = torch.empty_like(x)
    _launch_chains(x, weights, kernel_sizes, dilations, slope, out, 1.0 / len(kernel_sizes),
                   0.0, counter)
    return out


def _launch_group_packed(x, weights, kernel_sizes: Sequence[int],
                         dilations: Sequence[Sequence[int]], channels: int, t_valid: int,
                         slope: float) -> torch.Tensor:
    """K1's launches on the unfolded packed x, folded back (the forward of
    `GroupPackedFunction`)."""
    _check_packed(x, channels, t_valid)
    y = _launch_group(_unfold(x, channels, t_valid), weights, kernel_sizes, dilations, slope,
                      counter="resblock_group_packed")
    return _fold(y, x.shape[1])


def _per_step_chain(x, w1, b1, w2, b2, kernel_size, dilations, slope, out, alpha,
                    beta) -> None:
    """The per-step kernel's launches of one chain; the last writes alpha *
    chain + beta * out. Counts nothing."""
    B, T, C = x.shape
    K = kernel_size
    if K % 2 == 0 or w1.shape[1:] != (K, C, C) or w2.shape[1:] != (K, C, C):
        raise ValueError(f"resblock per-step: weights {tuple(w1.shape)} do not match "
                         f"kernel {K} and C={C}")
    fn = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    w1, w2 = _step_weights(w1), _step_weights(w2)
    b1, b2 = b1.contiguous(), b2.contiguous()
    tmp = [torch.empty_like(x), torch.empty_like(x)]
    cur = x
    for s, d in enumerate(dilations):
        last = s == len(dilations) - 1
        dst = out if last else tmp[s % 2]
        err = fn(cur.data_ptr(), dst.data_ptr(), w1[s].data_ptr(), b1[s].data_ptr(),
                 w2[s].data_ptr(), b2[s].data_ptr(), B, T, C, K, d, slope,
                 alpha if last else 1.0, beta if last else 0.0, stream)
        build.check(err, "resblock per-step")
        cur = dst


def resblock_group_per_step(x, weights, kernel_sizes, dilations, slope: float = 0.1):
    """K1's function by the per-step kernel, one launch per dilation step (a
    yardstick: no path calls it, it counts no launches). CUDA tensors."""
    _check(x, weights, "resblock per-step")
    x = _aligned(x)
    out = torch.empty_like(x)
    n = len(kernel_sizes)
    for i, k in enumerate(kernel_sizes):
        _per_step_chain(x, *weights[4 * i: 4 * i + 4], k, dilations[i], slope, out, 1.0 / n,
                        0.0 if i == 0 else 1.0)
    return out


def resblock_chain_per_step(x, w1, b1, w2, b2, kernel_size, dilations=(1, 3, 5),
                            slope: float = 0.1):
    """K2's function by the per-step kernel (a yardstick, as
    `resblock_group_per_step`)."""
    _check(x, (w1, b1, w2, b2), "resblock per-step")
    x = _aligned(x)
    out = torch.empty_like(x)
    _per_step_chain(x, w1, b1, w2, b2, kernel_size, dilations, slope, out, 1.0, 0.0)
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
    w1, w2 = _step_weights(w1), _step_weights(w2)
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
    the whole chains by K1's launch (alpha 1 / n), then each sharded chain by
    the partial-sum launches, added / n after its last all-reduce."""
    _check(x, weights, "resblock_group_tp")
    x = _aligned(x)
    out = torch.empty_like(x)
    n = len(kernel_sizes)
    whole = [i for i in range(n) if not _sharded(x, weights[4 * i])]
    if whole:
        _launch_chains(x, tuple(t for i in whole for t in weights[4 * i: 4 * i + 4]),
                       [kernel_sizes[i] for i in whole], [dilations[i] for i in whole], slope,
                       out, 1.0 / n, 0.0, "resblock_group")
    first = not whole
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


class GroupPackedFunction(torch.autograd.Function):
    """K1 on the packed layout under autograd: `forward` (the launches; any
    callable with `resblock_group_packed_reference`'s signature) computes
    the output; the backward unfolds, takes the float32 plain stage's
    autograd and refolds (`resblock_group_packed_reference`'s autograd)."""

    @staticmethod
    def forward(ctx, forward, kernel_sizes, dilations, channels, t_valid, slope, x, *weights):
        ctx.save_for_backward(x, *weights)
        ctx.args = (kernel_sizes, dilations, channels, t_valid, slope)
        return forward(x, weights, kernel_sizes, dilations, channels, t_valid, slope)

    @staticmethod
    def backward(ctx, grad):
        ks, ds, c, t, slope = ctx.args
        grads = plain_vjp(
            lambda x, *w: resblock_group_packed_reference(x, w, ks, ds, c, t, slope),
            ctx.saved_tensors, ctx.needs_input_grad[6:], grad)
        return (None,) * 6 + grads


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


@recorded
def resblock_group_packed(x: torch.Tensor, weights: tuple, kernel_sizes: Sequence[int],
                          dilations: Sequence[Sequence[int]], channels: int, t_valid: int,
                          slope: float = 0.1) -> torch.Tensor:
    """K1 on the packed lane layout: x (B, R, P * C) float32, P = 128 // C,
    C = channels in (128, 64, 32), its first t_valid <= R * P steps valid
    (see the module's docstring); returns the same layout."""
    if x.device.type == "cpu":
        return resblock_group_packed_reference(x, weights, kernel_sizes, dilations, channels,
                                               t_valid, slope)
    return GroupPackedFunction.apply(_launch_group_packed, tuple(kernel_sizes),
                                     tuple(tuple(d) for d in dilations), channels, t_valid,
                                     slope, x, *weights)
