"""Tile-size choice shared by the plan builders.

Copied from block2_preview_tpu/ops/tiled.py:39-66 (``pick_tile`` only;
the v1 tiled engine is not on this slice).
"""

from __future__ import annotations

import numpy as np


def pick_tile(dims: np.ndarray) -> int:
    """Choose tile size from the p90 of true block dims."""
    if len(dims) == 0:
        return 32
    p = float(np.percentile(dims, 90))
    if p <= 24:
        return 16
    if p <= 48:
        return 32
    if p <= 160:
        return 64
    return 128
