"""Hand-written CUDA kernels of the port, one wrapper module each.

| kernel | wrapper                             | source               | replaces (TPU kernel)                                   |
| K1     | resblock.resblock_group             | csrc/resblock.cu     | rvc_tpu/ops/pallas/resblock.py : fused_resblock_group   |
| K2     | resblock.resblock_chain             | csrc/resblock.cu     | rvc_tpu/ops/pallas/resblock.py : fused_resblock         |
| K3     | attention.rel_attention             | csrc/rel_attention.cu| rvc_tpu/ops/pallas/attention.py : fused_rel_attention   |
| K4     | melspec.log_mel                     | csrc/melspec.cu      | rvc_tpu/ops/pallas/melspec.py : pallas_log_mel          |
| K1 TP  | resblock.resblock_group_tp          | csrc/resblock.cu     | K1's partial-sum launch on a tensor-parallel rank       |
| K2 TP  | resblock.resblock_chain_tp          | csrc/resblock.cu     | K2's partial-sum launch on a tensor-parallel rank       |
| K1 pk  | resblock.resblock_group_packed      | csrc/resblock.cu     | rvc_tpu/ops/pallas/resblock.py : resblock_group_packed  |

Each wrapper `<name>` has a plain PyTorch version `<name>_reference` with
the same signature, which it runs for CPU tensors (the `_tp` wrappers:
`resblock_chain_partial_reference`, `resblock_group_partial_reference`).

`LAUNCHES` counts each wrapper's kernel launches (and nothing else), so a
run can show that the main path went through the kernels; `count_launch`
adds one under a lock (`BatchConverter`'s mesh launches from one host
thread per device). `CONVERSIONS` counts K1/K2's weight conversions
(`resblock.cached`'s misses) by `cached`'s tag: "stage" for the one-pass
kernel's buffers, "step" for the per-step kernel's; `reset_launches` zeroes
both counters, `count_launch(tag, CONVERSIONS)` adds to the second. `record_calls`
keeps a copy of every wrapper call made inside it, so the calls a run
made can be replayed and timed one by one (detached copies: a recording
holds no autograd graph). K1/K2's weight conversions are cached per
weight version (`resblock.cached`), so a replay, as a conversion, converts
once.

In training K1-K3 run under `torch.autograd.Function`s (`ChainFunction`,
`GroupFunction`, `RelAttentionFunction`; K1's packed entry
`GroupPackedFunction`): the forward is the kernel, the backward float32
autograd of the plain version re-run from the saved inputs (`plain_vjp`),
as the reference's `custom_vjp`s take XLA's autodiff of the plain chain
(`rvc_tpu/ops/pallas/resblock.py:_chain_bwd`, `_group_bwd`,
`_group_packed_bwd`; `attention.py:_bwd`). The JAX package has no backward
kernel, so neither has the port.
"""

from __future__ import annotations

import functools
import threading
from contextlib import contextmanager
from typing import Callable, Iterator, List, Optional, Sequence

import torch

LAUNCHES = {"resblock_group": 0, "resblock_chain": 0, "rel_attention": 0,
            "log_mel": 0, "resblock_group_tp": 0, "resblock_chain_tp": 0,
            "resblock_group_packed": 0}
CONVERSIONS = {"stage": 0, "step": 0}

_recording: Optional[List[tuple]] = None
_count_lock = threading.Lock()


def reset_launches() -> None:
    for counter in (LAUNCHES, CONVERSIONS):
        for name in counter:
            counter[name] = 0


def count_launch(name: str, counter: dict = LAUNCHES) -> None:
    with _count_lock:
        counter[name] = counter.get(name, 0) + 1


def _copy(obj):
    if hasattr(obj, "detach"):
        return obj.detach().clone()
    if isinstance(obj, (tuple, list)):
        return type(obj)(_copy(o) for o in obj)
    return obj


def recorded(fn):
    """Mark a kernel wrapper: inside `record_calls` each call is kept (as
    normal tensors, also inside inference mode, so that a replay finds the
    weight conversions cached as the recorded run did)."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if _recording is not None:
            with torch.inference_mode(False):
                _recording.append((fn, _copy(args), {k: _copy(v) for k, v in kwargs.items()}))
        return fn(*args, **kwargs)
    return wrapper


@contextmanager
def record_calls() -> Iterator[List[tuple]]:
    """Yield a list that fills with (fn, args, kwargs) for every wrapper
    call made in the block, the tensors copied as they were passed. `fn`
    is the undecorated wrapper, so a replay records nothing."""
    global _recording
    calls: List[tuple] = []
    _recording = calls
    try:
        yield calls
    finally:
        _recording = None


def plain_vjp(plain: Callable, inputs: Sequence[torch.Tensor], needs: Sequence[bool],
              grad: torch.Tensor) -> tuple:
    """The gradients of plain(*inputs) against `grad` for the inputs that
    `needs` marks (None for the others): the plain version re-run in
    float32 under autograd, from the saved inputs."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(bool(n)) for t, n in zip(inputs, needs)]
        want = [t for t, n in zip(leaves, needs) if n]
        grads = iter(torch.autograd.grad(plain(*leaves), want, grad) if want else ())
    return tuple(next(grads) if n else None for n in needs)
