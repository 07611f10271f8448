"""Circular buffer write (a copy of `rvc_tpu/realtime/buffer.py`; reference
`rvc_mlx/realtime/utils/buffer.py:3`)."""

from __future__ import annotations

import numpy as np


def circular_write(data: np.ndarray, buffer: np.ndarray) -> np.ndarray:
    """Shift `buffer` left by len(data) and write `data` at the tail
    (in place). If data is longer than the buffer, keep its tail."""
    n = len(data)
    if n >= len(buffer):
        buffer[:] = data[-len(buffer):]
    else:
        buffer[:-n] = buffer[n:]
        buffer[-n:] = data
    return buffer
