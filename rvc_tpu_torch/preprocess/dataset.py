"""Dataset builder: validated filelists with frame filters + train/val split
(a copy of `rvc_tpu/preprocess/dataset.py`, the mutes extracted by the
port's `FeatureExtractor`; the port imports nothing of `rvc_tpu`).

Capability parity with `rvc_mlx/preprocess/dataset_builder.py` and
`rvc/train/extract/preparing_files.py`: rows of
``audio|features|f0|f0_coarse|sid|spec``, min/max frame filter (50..900,
the torch loader's bucket bounds), deterministic shuffled split.
"""

from __future__ import annotations

import os
import random
from typing import List, Tuple

import numpy as np

MIN_FRAMES = 50
MAX_FRAMES = 900


class DatasetBuilder:
    def __init__(self, exp_dir: str, min_frames: int = MIN_FRAMES,
                 max_frames: int = MAX_FRAMES):
        self.exp_dir = exp_dir
        self.min_frames = min_frames
        self.max_frames = max_frames

    def collect(self) -> List[dict]:
        gt = os.path.join(self.exp_dir, "sliced_audios")
        feats = os.path.join(self.exp_dir, "features")
        f0d = os.path.join(self.exp_dir, "f0_voiced")
        f0c = os.path.join(self.exp_dir, "f0")
        spec = os.path.join(self.exp_dir, "spec")
        rows = []
        for f in sorted(os.listdir(feats) if os.path.isdir(feats) else []):
            if not f.endswith(".npy"):
                continue
            name = os.path.splitext(f)[0]
            paths = {
                "audio": os.path.join(gt, name + ".wav"),
                "features": os.path.join(feats, f),
                "f0": os.path.join(f0d, f),
                "f0_coarse": os.path.join(f0c, f),
                "spec": os.path.join(spec, f),
            }
            if not all(os.path.exists(p) for p in paths.values()):
                continue
            try:
                n_frames = np.load(paths["spec"], mmap_mode="r").shape[0]
            except Exception:
                continue
            if not (self.min_frames <= n_frames <= self.max_frames):
                continue
            sid = int(name.split("_")[0]) if name.split("_")[0].isdigit() else 0
            rows.append({**paths, "sid": sid, "n_frames": int(n_frames)})
        return rows

    def build(self, val_fraction: float = 0.02, seed: int = 1234
              ) -> Tuple[List[dict], List[dict]]:
        rows = self.collect()
        rng = random.Random(seed)
        rng.shuffle(rows)
        n_val = max(1, int(len(rows) * val_fraction)) if len(rows) > 1 else 0
        return rows[n_val:], rows[:n_val]

    def write_filelist(self, path: str, rows: List[dict]) -> None:
        with open(path, "w") as f:
            for r in rows:
                f.write("|".join([r["audio"], r["features"], r["f0"],
                                  r["f0_coarse"], str(r["sid"]), r["spec"]]) + "\n")

    def add_mutes(self, cfg, include_mutes: int = 2,
                  feature_extractor=None) -> List[dict]:
        """Append `include_mutes` mute samples per speaker (reference
        `preparing_files.py:58-67`, which ships pre-made mute assets —
        ours are generated in place: 3 s of silence run through the same
        feature extraction)."""
        from rvc_tpu_torch.utils import audio as audio_utils

        rows = self.collect()
        sids = sorted({r["sid"] for r in rows}) or [0]

        mute_dir = os.path.join(self.exp_dir, "mute")
        os.makedirs(mute_dir, exist_ok=True)
        name = "mute"
        gt = os.path.join(mute_dir, f"{name}.wav")
        g16 = os.path.join(mute_dir, f"{name}_16k.wav")
        if not os.path.exists(gt):
            sr = cfg.data.sample_rate
            audio_utils.save_wav(gt, np.zeros(3 * sr, np.float32), sr, "FLOAT")
            audio_utils.save_wav(g16, np.zeros(3 * 16000, np.float32), 16000, "FLOAT")
        feats_p = os.path.join(mute_dir, "features.npy")
        if not os.path.exists(feats_p):
            if feature_extractor is None:
                from rvc_tpu_torch.preprocess.features import FeatureExtractor

                feature_extractor = FeatureExtractor(mute_dir, cfg)
            out = feature_extractor.process_pair(name, g16, gt)
            os.replace(out["features"], feats_p)
            os.replace(out["f0"], os.path.join(mute_dir, "f0_coarse.npy"))
            os.replace(out["f0_voiced"], os.path.join(mute_dir, "f0.npy"))
            os.replace(out["spec"], os.path.join(mute_dir, "spec.npy"))

        n_frames = int(np.load(os.path.join(mute_dir, "spec.npy"),
                                mmap_mode="r").shape[0])
        mute_rows = []
        for sid in sids * include_mutes:
            mute_rows.append({
                "audio": gt,
                "features": feats_p,
                "f0": os.path.join(mute_dir, "f0.npy"),
                "f0_coarse": os.path.join(mute_dir, "f0_coarse.npy"),
                "spec": os.path.join(mute_dir, "spec.npy"),
                "sid": sid, "n_frames": n_frames,
            })
        return mute_rows

    @staticmethod
    def read_filelist(path: str) -> List[dict]:
        rows = []
        with open(path) as f:
            for line in f:
                parts = line.strip().split("|")
                if len(parts) < 5:
                    continue
                row = {"audio": parts[0], "features": parts[1], "f0": parts[2],
                       "f0_coarse": parts[3], "sid": int(parts[4])}
                if len(parts) > 5:
                    row["spec"] = parts[5]
                rows.append(row)
        return rows
