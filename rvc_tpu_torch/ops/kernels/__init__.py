"""Hand-written CUDA kernels of the port, one wrapper module each.

| kernel | wrapper                             | source               | replaces (TPU kernel)                                   |
| K1     | resblock.resblock_group             | csrc/resblock.cu     | rvc_tpu/ops/pallas/resblock.py : fused_resblock_group   |
| K2     | resblock.resblock_chain             | csrc/resblock.cu     | rvc_tpu/ops/pallas/resblock.py : fused_resblock         |
| K3     | attention.rel_attention             | csrc/rel_attention.cu| rvc_tpu/ops/pallas/attention.py : fused_rel_attention   |
| K4     | melspec.log_mel                     | csrc/melspec.cu      | rvc_tpu/ops/pallas/melspec.py : pallas_log_mel          |

Each wrapper `<name>` has a plain PyTorch version `<name>_reference` with
the same signature, which it runs for CPU tensors.

`LAUNCHES` counts each wrapper's kernel launches (and nothing else), so a
run can show that the main path went through the kernels. `record_calls`
keeps a copy of every wrapper call made inside it, so the calls a run
made can be replayed and timed one by one.
"""

from __future__ import annotations

import functools
from contextlib import contextmanager
from typing import Iterator, List, Optional

LAUNCHES = {"resblock_group": 0, "resblock_chain": 0, "rel_attention": 0,
            "log_mel": 0}

_recording: Optional[List[tuple]] = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _copy(obj):
    if hasattr(obj, "detach"):
        return obj.detach().clone()
    if isinstance(obj, (tuple, list)):
        return type(obj)(_copy(o) for o in obj)
    return obj


def recorded(fn):
    """Mark a kernel wrapper: inside `record_calls` each call is kept."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if _recording is not None:
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
