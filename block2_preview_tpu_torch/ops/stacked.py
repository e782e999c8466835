"""Symbol-stacked environment layout (host side, numpy).

Copied from block2_preview_tpu/ops/stacked.py:44-160, 547-554 without the
JAX kernels of that file: ``_pow2``, ``_cap_class``, ``StackedMeta`` and
``meta_from_env`` must give byte-identical layouts to the reference, so
every port kernel reads the same flat pools as its JAX counterpart.

The environment of one bond lives in ONE flat pool, slab-contiguous: the
slab for (group g, sector qb) holds the S_g symbols of the group as
contiguous (db x dk) row-major blocks.  Pools shipped to the device carry
one extra zero slot at the end (the sentinel that masked reads use).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from block2_preview_tpu.core.blocks import BlockMatrix
from block2_preview_tpu.core.symmetry import QN


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length() if n > 0 else 1


def _cap_class(n: int) -> int:
    """Quantized pool capacity.  pow4 steps while small, pow2 above 4M
    elements (the reference's size classes; kept so pool layouts and
    sentinel positions match it exactly)."""
    c = 1 << 16
    while c < n and c < (1 << 22):
        c <<= 2
    while c < n:
        c <<= 1
    return c


class StackedMeta:
    """Layout of a stacked environment on one bond.

    groups: list of (dq, sym_ids [S]) — symbols sharing a delta quantum.
    sectors[g]: {qb: (offset, db, dk)} — slab offsets into the flat pool;
    the slab for (g, qb) holds S_g contiguous (db x dk) blocks.
    total: pool length (+1 sentinel slot at the end when shipped).
    """

    __slots__ = ("groups", "sectors", "total", "sym_pos", "_sig")

    def __init__(self, groups, sectors, total):
        self.groups = groups
        self.sectors = sectors
        self.total = total
        self._sig = None
        self.sym_pos: Dict[int, Tuple[int, int]] = {}
        for g, (_dq, syms) in enumerate(groups):
            for j, s in enumerate(syms):
                self.sym_pos[int(s)] = (g, j)

    def signature(self) -> int:
        """Structural hash (groups + sector layout), cached."""
        s = getattr(self, "_sig", None)
        if s is None:
            s = hash((tuple((dq, tuple(map(int, ss)))
                            for dq, ss in self.groups),
                      tuple(tuple(sorted(sec.items()))
                            for sec in self.sectors), self.total))
            self._sig = s
        return s

    @staticmethod
    def from_bond(bond_dqs: Sequence[QN], sym_sectors: Dict[int, Dict],
                  active: Optional[Sequence[int]] = None) -> "StackedMeta":
        """bond_dqs[s] = dq of symbol s; sym_sectors[s] = {qb: (db, dk)}."""
        syms = sorted(sym_sectors) if active is None else sorted(active)
        by_dq: Dict[QN, List[int]] = {}
        for s in syms:
            by_dq.setdefault(bond_dqs[s], []).append(s)
        groups = []
        sectors = []
        off = 0
        for dq in sorted(by_dq):
            ss = np.asarray(by_dq[dq], dtype=np.int64)
            # union of sectors over the group, with per-sector dims
            secs: Dict[QN, Tuple[int, int]] = {}
            for s in ss:
                for qb, (db, dk) in sym_sectors[int(s)].items():
                    if qb in secs:
                        if secs[qb] != (db, dk):
                            raise ValueError("inconsistent sector dims")
                    else:
                        secs[qb] = (db, dk)
            lay = {}
            for qb in sorted(secs):
                db, dk = secs[qb]
                lay[qb] = (off, db, dk)
                off += len(ss) * db * dk
            groups.append((dq, ss))
            sectors.append(lay)
        return StackedMeta(groups, sectors, off)

    def pack(self, env: Dict[int, BlockMatrix], dtype=np.float64
             ) -> np.ndarray:
        pool = np.zeros(self.total + 1, dtype=dtype)
        for g, (_dq, ss) in enumerate(self.groups):
            for j, s in enumerate(ss):
                bm = env.get(int(s))
                if bm is None:
                    continue
                for (qb, _qk), mat in bm.blocks.items():
                    ent = self.sectors[g].get(qb)
                    if ent is None:
                        continue
                    off, db, dk = ent
                    o = off + j * db * dk
                    pool[o:o + db * dk] = np.asarray(mat, dtype=dtype).ravel()
        return pool

    def unpack(self, pool: np.ndarray, group, bond_dqs,
               comp_target: Optional[QN] = None) -> Dict[int, BlockMatrix]:
        out: Dict[int, BlockMatrix] = {}
        pool = np.asarray(pool)
        for g, (dq, ss) in enumerate(self.groups):
            for qb, (off, db, dk) in self.sectors[g].items():
                qk = group.sub(qb, dq)
                for j, s in enumerate(ss):
                    o = off + j * db * dk
                    mat = pool[o:o + db * dk].reshape(db, dk)
                    if not np.any(mat):
                        continue
                    bm = out.get(int(s))
                    if bm is None:
                        bm = BlockMatrix(group, dq)
                        out[int(s)] = bm
                    bm.blocks[(qb, qk)] = mat
        return out


def meta_from_env(env: Dict[int, BlockMatrix], bond_dqs: Sequence[QN]
                  ) -> StackedMeta:
    """StackedMeta from a materialized {symbol -> BlockMatrix} env."""
    sym_sectors = {}
    for s, bm in env.items():
        sym_sectors[int(s)] = {qb: mat.shape
                               for (qb, _qk), mat in bm.blocks.items()}
    return StackedMeta.from_bond(bond_dqs, sym_sectors)


def env_pool(env: Dict[int, BlockMatrix], bond_dqs: Sequence[QN], dtype
             ) -> Tuple[StackedMeta, np.ndarray]:
    """(meta, host pool) of one bond's environment, padded to
    ``_cap_class(n + 1)`` with the zero sentinel in the last slot — the
    same layout the reference's ``MovingEnvironment._ensure_stk`` ships
    (block2_preview_tpu/dmrg/environment.py:515-538)."""
    meta = meta_from_env(env, bond_dqs)
    pool = meta.pack(env, dtype=dtype)
    # strictly > len: the last slot is the zero sentinel that masked
    # tile reads rely on — it must never hold real data
    pp = np.zeros(_cap_class(len(pool) + 1), dtype=dtype)
    pp[:len(pool)] = pool
    return meta, pp
