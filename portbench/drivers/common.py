"""What the drivers share: the program's configuration from a configuration
file, the seeded networks of both sides, the comparison of waveforms, and
the record of the work a traced window did."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch

from portbench import weights
from portbench.reference import nets

# the weight streams of one seed: one draw per network
STREAMS = {"hubert": 0, "rmvpe": 1, "synthesizer": 2, "discriminator": 3}


def reference_nets(config: dict, seed: int, device, kinds=("hubert", "rmvpe", "synthesizer"),
                   training: bool = False) -> Dict[str, torch.nn.Module]:
    """The plain reference's networks of this configuration on `device`,
    with the seed's weights."""
    out = {}
    for kind in kinds:
        with torch.device("meta"):
            shell = nets.build(kind, config, training)
        net = shell.to_empty(device=device)
        net.load_state_dict(weights.make(net, seed, device, STREAMS[kind]))
        out[kind] = net.eval().requires_grad_(False)
    return out


def seeded_states(config: dict, seed: int, device, kinds=("hubert", "rmvpe", "synthesizer"),
                  training: bool = False) -> Dict[str, Dict[str, torch.Tensor]]:
    """The state dicts the program is handed (the same draws as
    `reference_nets`)."""
    out = {}
    for kind in kinds:
        with torch.device("meta"):
            shell = nets.build(kind, config, training)
        out[kind] = weights.make(shell.to_empty(device=device), seed, device, STREAMS[kind])
    return out


def sync(device) -> None:
    """Wait for the device's queued work (a no-op on the host)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def strict_float32() -> None:
    """The reference's numerics: float32 products without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rel_l2(got: np.ndarray, ref: np.ndarray) -> float:
    """||got - ref|| / ||ref||; inf where the shapes differ or got is not finite."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if got.shape != ref.shape or not np.all(np.isfinite(got)):
        return float("inf")
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def verdict(value: float, limit: float) -> dict:
    return {"value": value, "limit": limit, "ok": bool(value <= limit)}


@dataclass
class Snapshot:
    """The work a traced part of the window did."""
    work: float = 0.0                   # audio seconds or steps
    flop: float = 0.0                   # model FLOP of that work
    spans: Dict[str, float] = field(default_factory=dict)


@dataclass
class Layer:
    """What a per-layer metric's reader gets: the reduced trace, the traced
    part's work, and what each wrapped range's `observe` gathered, by range."""
    trace: object
    snap: Snapshot
    acc: Dict[str, dict] = field(default_factory=dict)


class Wraps:
    """The `record_function` ranges the cell's per-layer readers ask for.

    A reader module may name `WRAP`, the callable to run inside its range
    `RANGE`: `<root>.<method>` on one of the objects the driver names in
    `roots()` (e.g. `pipeline.f0`), or a module attribute of the program
    (`rvc_tpu_torch.models.generators._stage_resblocks`). Its optional
    `observe(acc, *args, **kwargs)` sees each call's arguments first and
    gathers into the range's dict. `on()` wraps, `off()` restores; a
    target the program lacks is skipped, and its reader finds nothing."""

    def __init__(self, readers, roots: Dict[str, object]):
        self.acc: Dict[str, dict] = {}
        self._plan, seen = [], set()
        for r in readers:
            target = getattr(r, "WRAP", None)
            if target is None or (target, r.RANGE) in seen:
                continue
            seen.add((target, r.RANGE))
            self._plan.append((target, r.RANGE, getattr(r, "observe", None)))
        self.roots, self._undo = roots, []

    def _owner(self, target: str):
        head, attr = target.rsplit(".", 1)
        if head in self.roots:
            return self.roots[head], attr
        if head.split(".")[0] == "rvc_tpu_torch":
            import importlib

            try:
                return importlib.import_module(head), attr
            except ImportError:
                return None, attr
        return None, attr

    def on(self) -> None:
        for target, rng, observe in self._plan:
            owner, attr = self._owner(target)
            orig = getattr(owner, attr, None) if owner is not None else None
            if orig is None:
                continue
            acc = self.acc.setdefault(rng, {})

            def wrapped(*a, _orig=orig, _rng=rng, _obs=observe, _acc=acc, **k):
                if _obs is not None:
                    _obs(_acc, *a, **k)
                with torch.profiler.record_function(_rng):
                    return _orig(*a, **k)

            had = attr in vars(owner)
            setattr(owner, attr, wrapped)
            self._undo.append((owner, attr, orig if had else None))

    def off(self) -> None:
        for owner, attr, orig in reversed(self._undo):
            if orig is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, orig)
        self._undo = []
