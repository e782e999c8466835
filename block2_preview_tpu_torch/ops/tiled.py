"""Tile-size choice shared by the plan builders.

Copied from block2_preview_tpu/ops/tiled.py:39-66 (``pick_tile`` and
``_TILE_CFG`` only; the v1 tiled engine is not on this slice).
"""

from __future__ import annotations

import numpy as np

# per tile size: (task chunk B, tmp pool tiles)
_TILE_CFG = {16: (8192, 16384), 32: (8192, 8192), 64: (4096, 4096),
             128: (4096, 2048)}


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
