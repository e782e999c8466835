"""SU(2) non-abelian quantum numbers and multiplet bookkeeping.

Counterpart of block2's SU2 quantum-number structs (reference
src/core/symmetry.hpp:955,1067: SU2Long with N, 2S, pg and multi-valued
`operator+` enumerating spin fusion channels) and the SU(2) StateInfo tensor
products (reference src/core/state_info.hpp:229 specialized over S=SU2).

A multiplet label is (n, 2S, pg) with 2S >= 0.  Fusion is multi-valued:
(n1,2S1,pg1) x (n2,2S2,pg2) -> { (n1+n2, 2S, pg1^pg2) :
                                  |2S1-2S2| <= 2S <= 2S1+2S2, step 2 }.
Together with core/clebsch_gordan.py this is the bookkeeping layer of the
spin-adapted sweep engine (dmrg/su2_fermion.py).

Copied from block2_preview_tpu/core/su2.py
(the port keeps its own copy).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .state_info import StateInfo
from .symmetry import QN, SymmetryGroup

# abelian shell reused for neg/zero bookkeeping of (n, 2s, pg); `add` on the
# 2s factor is NOT meaningful — use fuse() below
SU2_GROUP = SymmetryGroup(("u1", "u1", "xor"), ("n", "twos", "pg"))


def su2_fuse(a: QN, b: QN) -> List[QN]:
    """All multiplets in a (x) b."""
    n = a[0] + b[0]
    pg = a[2] ^ b[2]
    lo, hi = abs(a[1] - b[1]), a[1] + b[1]
    return [(n, ts, pg) for ts in range(lo, hi + 1, 2)]


def su2_tensor_product(a: StateInfo, b: StateInfo) -> StateInfo:
    """Multiplet-counting tensor product (reference state_info.hpp:229 for
    S=SU2: multiplicities accumulate over all fusion channels)."""
    out: Dict[QN, int] = {}
    for qa, na in a.items():
        for qb, nb in b.items():
            for q in su2_fuse(qa, qb):
                out[q] = out.get(q, 0) + na * nb
    return StateInfo(a.group, out)


def su2_site_basis_quanta(pg: int = 0) -> List[QN]:
    """Spatial-orbital SU(2) site: |0>, |singly occ (S=1/2)>, |2>."""
    return [(0, 0, 0), (1, 1, pg), (2, 0, 0)]


def su2_site_info(pg: int = 0) -> StateInfo:
    return StateInfo(SU2_GROUP, {q: 1 for q in su2_site_basis_quanta(pg)})


def count_spin_multiplets(n_spins: int) -> Dict[int, int]:
    """Number of total-spin-S multiplets from n spin-1/2s (the Catalan
    triangle); sanity anchor for the fusion bookkeeping."""
    cur = {0: 1}
    for _ in range(n_spins):
        nxt: Dict[int, int] = {}
        for ts, m in cur.items():
            for ts2 in ({1} if ts == 0 else {ts - 1, ts + 1}):
                nxt[ts2] = nxt.get(ts2, 0) + m
        cur = nxt
    return cur
