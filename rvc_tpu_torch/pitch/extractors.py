"""Pitch-extractor facade (counterpart of `rvc_tpu/pitch/extractors.py`).

``PitchExtractor(method, device=...).extract(audio, f0_min, f0_max)`` over
rmvpe, crepe, crepe-tiny, fcpe (neural, on `device`), dio, pm, harvest
(host numpy; pyworld's WORLD when it is installed, as the reference
chooses) and hybrid[a+b+...] combinations (the per-frame median of the
voiced estimates where most methods call the frame voiced). `extract`
returns numpy on the 10 ms grid, 0 = unvoiced.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from rvc_tpu_torch.utils.device import resolve_device

try:
    import pyworld  # optional C++ WORLD bindings
    _HAS_PYWORLD = True
except ImportError:
    pyworld = None
    _HAS_PYWORLD = False


class PitchExtractor:
    """model: the method's predictor (`RMVPE`, `CREPE`, `FCPE`), used as it
    is; rmvpe: the `RMVPE` that `rmvpe` and hybrid components use (the
    pipeline passes the one over its own E2E). A predictor not given is
    built on the host from torch seed 0 and moved to `device`: None is the
    card (raising when there is none), "cpu" the host. crepe_hop: CREPE's
    analysis hop in 16 kHz samples, resampled onto the 160-sample grid."""

    METHODS = ["rmvpe", "dio", "pm", "harvest", "crepe", "crepe-tiny", "fcpe"]

    def __init__(self, method: str = "rmvpe", sample_rate: int = 16000, hop_size: int = 160,
                 *, model=None, crepe_hop: int = 160, device=None, rmvpe=None):
        self.method = method
        self.sample_rate = sample_rate
        self.hop_size = hop_size
        self.crepe_hop = crepe_hop
        self._sub = None
        self._model = model
        if method.startswith("hybrid[") and method.endswith("]"):
            subs = method[len("hybrid["):-1].split("+")
            for s in subs:
                if s not in self.METHODS:
                    raise ValueError(f"unknown hybrid component {s!r}")
            self._sub = [PitchExtractor(s, sample_rate, hop_size, crepe_hop=crepe_hop,
                                        device=device, rmvpe=rmvpe) for s in subs]
            return
        if method not in self.METHODS:
            raise ValueError(f"unknown pitch method {method!r}; choose from {self.METHODS}")
        if method == "rmvpe" and model is None:
            self._model = rmvpe
        if self._model is None and method in ("rmvpe", "crepe", "crepe-tiny", "fcpe"):
            device = resolve_device(device)
            if method == "rmvpe":
                from rvc_tpu_torch.models.rmvpe import RMVPE

                self._model = RMVPE(device=device)
            elif method == "fcpe":
                from rvc_tpu_torch.models.fcpe import FCPE

                self._model = FCPE(device=device)
            else:
                from rvc_tpu_torch.models.crepe import CREPE

                self._model = CREPE("tiny" if method.endswith("tiny") else "full",
                                    device=device)

    def extract(self, audio: np.ndarray, f0_min: float = 50.0,
                f0_max: float = 1100.0) -> np.ndarray:
        """audio (T,) @16 kHz -> per-frame f0 (hop 160), 0 = unvoiced."""
        audio = np.asarray(audio, dtype=np.float32)
        if self._sub is not None:
            ests = [s.extract(audio, f0_min, f0_max) for s in self._sub]
            n = min(len(e) for e in ests)
            stack = np.stack([e[:n] for e in ests])  # (M, n)
            voiced = stack > 0
            med = np.zeros(n, dtype=np.float32)
            with np.errstate(all="ignore"):
                med_all = np.nanmedian(np.where(voiced, stack, np.nan), axis=0)
            # a frame counts as voiced when a majority of methods agree
            maj = voiced.sum(axis=0) >= (len(ests) + 1) // 2
            med[maj] = med_all[maj]
            return med
        m = self.method
        if m == "rmvpe":
            f0 = self._model.infer_from_audio(audio, thred=0.03)
        elif m == "fcpe":
            f0 = self._model.infer_from_audio(audio, threshold=0.03)
        elif m in ("crepe", "crepe-tiny"):
            f0 = self._model.get_f0(audio, f0_min, f0_max, hop=self.crepe_hop)
        elif m == "dio":
            f0 = self._dio(audio, f0_min, f0_max)
        elif m == "harvest":
            f0 = self._harvest(audio, f0_min, f0_max)
        else:
            f0 = self._pm(audio, f0_min, f0_max)
        return np.where((f0 >= f0_min) & (f0 <= f0_max), f0, 0.0).astype(np.float32)

    def extract_with_confidence(self, audio: np.ndarray, f0_min: float = 50.0,
                                f0_max: float = 1100.0) -> Tuple[np.ndarray, np.ndarray]:
        """(f0, confidence): CREPE's periodicity, else 1 where voiced."""
        f0 = self.extract(audio, f0_min, f0_max)
        if self.method in ("crepe", "crepe-tiny"):
            _, per = self._model.get_f0(audio, f0_min, f0_max, return_periodicity=True,
                                        hop=self.crepe_hop)
            return f0, per[: len(f0)]
        return f0, (f0 > 0).astype(np.float32)

    # --- DSP back ends (host) --------------------------------------------

    def _frame_period_ms(self) -> float:
        return 1000.0 * self.hop_size / self.sample_rate

    def _dio(self, audio, f0_min, f0_max):
        if _HAS_PYWORLD:
            f0, t = pyworld.dio(audio.astype(np.float64), self.sample_rate, f0_floor=f0_min,
                                f0_ceil=f0_max, frame_period=self._frame_period_ms())
            return pyworld.stonemask(audio.astype(np.float64), f0, t,
                                     self.sample_rate).astype(np.float32)
        from rvc_tpu_torch.pitch.dsp import stonemask_refine
        from rvc_tpu_torch.pitch.world_dsp import dio_f0

        f0 = dio_f0(audio, self.sample_rate, self.hop_size, f0_min, f0_max)
        return stonemask_refine(audio, f0, self.sample_rate, self.hop_size)

    def _harvest(self, audio, f0_min, f0_max):
        if _HAS_PYWORLD:
            f0, _ = pyworld.harvest(audio.astype(np.float64), self.sample_rate, f0_floor=f0_min,
                                    f0_ceil=f0_max, frame_period=self._frame_period_ms())
            return f0.astype(np.float32)
        from rvc_tpu_torch.pitch.world_dsp import harvest_f0

        return harvest_f0(audio, self.sample_rate, self.hop_size, f0_min, f0_max)

    def _pm(self, audio, f0_min, f0_max):
        from rvc_tpu_torch.pitch.dsp import yin_f0

        return yin_f0(audio, self.sample_rate, self.hop_size, f0_min, f0_max)
