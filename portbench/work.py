"""The yardstick's arithmetic: published peaks of one H100, the operations
and bytes of a layer from the shapes of its inputs, and a roofline bound.

Copied from `chip_smoke.py`'s `work` / `bound` and frozen here. The peaks
are NVIDIA's data sheet for the H100 SXM at its full 700 W (dense, no
sparsity); a run states the card's power limit beside every share of them.
Model FLOPs are counted by running the plain reference on the meta device
under `torch.utils.flop_counter.FlopCounterMode` (matrix products and
convolutions, two FLOP a multiply-add), plus what that counter does not
see: the GRU's products.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

PEAK_BF16 = 989e12        # FLOP/s, tensor cores, dense
PEAK_F32 = 67e12          # FLOP/s, outside the tensor cores
PEAK_HBM = 3.35e12        # bytes/s


def bound_s(flop: float, nbytes: float, peak: float = PEAK_BF16) -> float:
    """The least time the chip could take: max(FLOP / peak, bytes / HBM)."""
    return max(flop / peak, nbytes / PEAK_HBM)


def resblock_stage(batch: int, t: int, c: int, kernel_sizes: Sequence[int],
                   dilations: Sequence[Sequence[int]], elem_bytes: int = 4) -> Tuple[int, int]:
    """(FLOP, bytes) of one decoder stage's parallel ResBlocks (the mean of
    chains, each dilation step two 'same' convolutions C -> C): the input
    read once, every weight and bias once, the output written once."""
    taps = sum(2 * len(d) * k for k, d in zip(kernel_sizes, dilations))
    flop = 2 * batch * t * c * c * taps
    weights = sum(2 * len(d) * (k * c * c + c) for k, d in zip(kernel_sizes, dilations))
    return flop, elem_bytes * (2 * batch * t * c + weights)


def gru_flop(batch: int, t: int, n_in: int, hidden: int, directions: int = 2) -> int:
    """A GRU's products: three gates of input and hidden projections."""
    return directions * 2 * batch * t * 3 * hidden * (n_in + hidden)


def counted_flop(fn: Callable, *args) -> int:
    """FLOP of fn(*args) by torch's flop counter (run on meta tensors)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return int(counter.get_total_flops())
