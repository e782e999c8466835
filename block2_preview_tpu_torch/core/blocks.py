"""Block-sparse tensors keyed by quantum numbers (host-side representation).

Counterpart of block2's SparseMatrix<S,FL> / SparseMatrixInfo<S>
(reference src/core/sparse_matrix.hpp:48,876).  The crucial design difference:
these dict-of-ndarray objects exist only on the host, at plan-compile time.
The reference precomputes ConnectionInfo (sparse_matrix.hpp:71) to hoist block
pairing out of its hot loops; we go one step further and compile the entire
sigma-vector contraction into static bucketed GEMM plans (ops/plan.py) executed
on device as batched matmuls.

Conventions
-----------
* Operator ``BlockMatrix``: ``blocks[(q_bra, q_ket)]`` is a (d_bra, d_ket)
  ndarray; every block satisfies ``q_bra = dq + q_ket`` for one fixed ``dq``.
* MPS tensor ``MPSTensor``: ``blocks[(ql, qp, qr)]`` is a (dl, dp, dr) ndarray
  with ``ql + qp = qr`` (left-to-right charge flow, matching the reference's
  left-fused convention in mps.hpp).
* ``FusedBasis``: explicit offset maps of a product basis, the analog of the
  fused StateInfo + ConnectionInfo offsets.

Copied from block2_preview_tpu/core/blocks.py (the port keeps its own copy).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from .symmetry import QN, SymmetryGroup
from .state_info import StateInfo


class BlockMatrix:
    """Quantum-number-blocked operator with a definite delta quantum."""

    __slots__ = ("group", "dq", "blocks")

    def __init__(self, group: SymmetryGroup, dq: QN,
                 blocks: Optional[Dict[Tuple[QN, QN], np.ndarray]] = None):
        self.group = group
        self.dq = dq
        self.blocks: Dict[Tuple[QN, QN], np.ndarray] = blocks or {}

    def add_block(self, q_bra: QN, q_ket: QN, mat: np.ndarray) -> None:
        key = (q_bra, q_ket)
        if key in self.blocks:
            self.blocks[key] = self.blocks[key] + mat
        else:
            self.blocks[key] = mat

    def __iter__(self):
        return iter(self.blocks.items())

    def __len__(self):
        return len(self.blocks)

    def norm(self) -> float:
        return float(np.sqrt(sum(np.vdot(b, b).real for b in self.blocks.values())))

    def scaled(self, alpha) -> "BlockMatrix":
        return BlockMatrix(self.group, self.dq,
                           {k: alpha * v for k, v in self.blocks.items()})

    def check(self) -> None:
        g = self.group
        for (qb, qk) in self.blocks:
            assert g.add(self.dq, qk) == qb, (self.dq, qk, qb)


class MPSTensor:
    """3-index block-sparse MPS site tensor, blocks (ql, qp, qr) -> (dl,dp,dr)."""

    __slots__ = ("group", "blocks")

    def __init__(self, group: SymmetryGroup,
                 blocks: Optional[Dict[Tuple[QN, QN, QN], np.ndarray]] = None):
        self.group = group
        self.blocks: Dict[Tuple[QN, QN, QN], np.ndarray] = blocks or {}

    def check(self) -> None:
        for (ql, qp, qr), b in self.blocks.items():
            assert self.group.add(ql, qp) == qr, (ql, qp, qr)
            assert b.ndim == 3

    def norm(self) -> float:
        return float(np.sqrt(sum(np.vdot(b, b).real for b in self.blocks.values())))

    def scaled(self, alpha) -> "MPSTensor":
        return MPSTensor(self.group, {k: alpha * v for k, v in self.blocks.items()})

    def left_state_info(self) -> StateInfo:
        dims: Dict[QN, int] = {}
        for (ql, qp, qr), b in self.blocks.items():
            dims[ql] = max(dims.get(ql, 0), b.shape[0])
        return StateInfo(self.group, dims)

    def right_state_info(self) -> StateInfo:
        dims: Dict[QN, int] = {}
        for (ql, qp, qr), b in self.blocks.items():
            dims[qr] = max(dims.get(qr, 0), b.shape[2])
        return StateInfo(self.group, dims)


class FusedBasis:
    """Explicit fusing map of a product basis A (x) B.

    For each fused sector q: a list of (qa, qb, offset, da, db) runs laid out
    contiguously, so a fused vector restricted to sector q decomposes into
    subsector slices.  This is the static-offset analog of block2's
    StateInfo::tensor_product + ConnectionInfo (reference
    src/core/state_info.hpp:229, sparse_matrix.hpp:71).
    """

    __slots__ = ("group", "info", "maps")

    def __init__(self, group: SymmetryGroup, a: StateInfo, b: StateInfo,
                 target_filter: Optional[Tuple[StateInfo, QN]] = None):
        self.group = group
        # maps[q] = list of (qa, qb, offset, da, db)
        self.maps: Dict[QN, List[Tuple[QN, QN, int, int, int]]] = {}
        dims: Dict[QN, int] = {}
        for qa in a:
            da = a[qa]
            for qb in b:
                db = b[qb]
                q = group.add(qa, qb)
                if target_filter is not None:
                    other, target = target_filter
                    if group.sub(target, q) not in other:
                        continue
                off = dims.get(q, 0)
                self.maps.setdefault(q, []).append((qa, qb, off, da, db))
                dims[q] = off + da * db
        self.info = StateInfo(group, dims)

    def sub_offset(self, q: QN, qa: QN, qb: QN) -> Tuple[int, int, int]:
        for (xa, xb, off, da, db) in self.maps[q]:
            if xa == qa and xb == qb:
                return off, da, db
        raise KeyError((q, qa, qb))

    def sectors(self) -> Iterable[QN]:
        return self.maps.keys()
