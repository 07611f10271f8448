"""Convolutions on the reference's channels-last layout, with its weights.

Counterpart of `rvc_tpu/ops/conv.py`. Activations are (B, T, C) and
(B, H, W, C); weights come in the reference's storage layout and are
permuted (a view, no copy) into `torch.nn.functional`'s:

  conv1d:            (K, Cin // groups, Cout)   -> (Cout, Cin // groups, K)
  conv_transpose1d:  (K, Cin, Cout)             -> (Cin, Cout, K)
  conv2d:            (KH, KW, Cin // groups, Cout)
  conv_transpose2d:  (KH, KW, Cin, Cout)

The TPU lane rewrites of the reference (`_conv1d_cin1_framed`,
`_conv1d_cout1_packed`, the polyphase transposed conv) compute the same
function and have no counterpart here.

A bf16 convolution sums its products in float32, as the reference's
(`preferred_element_type=float32`) and cuDNN's on the card do. PyTorch's
CPU kernels do not always (its grouped conv1d sums in bf16: HuBERT's
positional conv came out at corr 0.75 against float32), so on the CPU a
bf16 convolution runs on the exact float32 upcasts and rounds its output.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

IntOrPair = Union[int, Tuple[int, int]]


def _float32_sums(conv):
    """`conv` with float32 sums for bf16 on the CPU (see the module note)."""
    @functools.wraps(conv)
    def wrapper(x, w, b=None, **kwargs):
        if x.device.type == "cpu" and x.dtype == torch.bfloat16:
            return conv(x.float(), w.float(), None if b is None else b.float(),
                        **kwargs).to(x.dtype)
        return conv(x, w, b, **kwargs)
    return wrapper


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


@_float32_sums
def conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, *,
           stride: int = 1, padding: IntOrPair = 0, dilation: int = 1,
           groups: int = 1) -> torch.Tensor:
    """x (B, T, Cin), w (K, Cin // groups, Cout) -> (B, T', Cout)."""
    lo, hi = _pair(padding)
    xc = x.transpose(1, 2)
    if lo != hi:
        xc = F.pad(xc, (lo, hi))
        lo = 0
    out = F.conv1d(xc, w.permute(2, 1, 0), b, stride=stride, padding=lo,
                   dilation=dilation, groups=groups)
    return out.transpose(1, 2)


@_float32_sums
def conv_transpose1d(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None, *, stride: int = 1,
                     padding: int = 0, output_padding: int = 0) -> torch.Tensor:
    """x (B, T, Cin), w (K, Cin, Cout) -> (B, (T-1)*stride - 2*padding + K
    + output_padding, Cout), PyTorch's output-size semantics."""
    out = F.conv_transpose1d(x.transpose(1, 2), w.permute(1, 2, 0), b,
                             stride=stride, padding=padding,
                             output_padding=output_padding)
    return out.transpose(1, 2)


@_float32_sums
def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, *,
           stride: IntOrPair = 1,
           padding: Union[IntOrPair, Sequence[Tuple[int, int]]] = 0,
           dilation: IntOrPair = 1, groups: int = 1) -> torch.Tensor:
    """x (B, H, W, Cin), w (KH, KW, Cin // groups, Cout) -> (B, H', W', Cout).

    padding is an int, an (h, w) pair, or ((top, bottom), (left, right)).
    """
    xc = x.permute(0, 3, 1, 2)
    if (isinstance(padding, (tuple, list)) and len(padding) == 2
            and isinstance(padding[0], (tuple, list))):
        (t, bt), (lft, r) = padding
        xc = F.pad(xc, (lft, r, t, bt))
        pad = (0, 0)
    else:
        pad = _pair(padding)
    out = F.conv2d(xc, w.permute(3, 2, 0, 1), b, stride=_pair(stride),
                   padding=pad, dilation=_pair(dilation), groups=groups)
    return out.permute(0, 2, 3, 1)


@_float32_sums
def conv_transpose2d(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None, *,
                     stride: IntOrPair = 1, padding: IntOrPair = 0,
                     output_padding: IntOrPair = 0) -> torch.Tensor:
    """x (B, H, W, Cin), w (KH, KW, Cin, Cout), PyTorch output-size semantics."""
    out = F.conv_transpose2d(x.permute(0, 3, 1, 2), w.permute(2, 3, 0, 1), b,
                             stride=_pair(stride), padding=_pair(padding),
                             output_padding=_pair(output_padding))
    return out.permute(0, 2, 3, 1)


def get_same_padding(kernel_size: int, dilation: int = 1) -> int:
    """'same' padding for odd kernels: (k*d - d) // 2."""
    return (kernel_size * dilation - dilation) // 2
