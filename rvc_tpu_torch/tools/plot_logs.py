"""Training-curve rendering from JSONL logs (a copy of
`rvc_tpu/tools/plot_logs.py`; the reference's tensorboard launcher
capability without the tensorboard dependency): reads the trainer's
train_log.jsonl / tracker metrics and writes a PNG dashboard.

Usage: python -m rvc_tpu_torch.tools.plot_logs logs/model/ckpt/train_log.jsonl
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List


def load_jsonl(path: str) -> List[Dict]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                try:
                    rows.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    return rows


def plot(path: str, out_path: str | None = None) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = load_jsonl(path)
    if not rows:
        raise SystemExit(f"no records in {path}")
    keys = [k for k in rows[0] if k.startswith("loss") or k in ("grad_norm_g",)]
    x = [r.get("epoch", r.get("step", i)) for i, r in enumerate(rows)]

    n = len(keys)
    cols = 3
    rowsn = (n + cols - 1) // cols
    fig, axes = plt.subplots(rowsn, cols, figsize=(4 * cols, 3 * rowsn),
                             squeeze=False)
    for i, k in enumerate(keys):
        ax = axes[i // cols][i % cols]
        ax.plot(x, [r.get(k) for r in rows])
        ax.set_title(k)
        ax.grid(alpha=0.3)
    for j in range(n, rowsn * cols):
        axes[j // cols][j % cols].axis("off")
    fig.tight_layout()
    out_path = out_path or path.replace(".jsonl", ".png")
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


if __name__ == "__main__":
    print(plot(sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else None))
