"""MPS and MPSInfo: quantum-number bond bookkeeping and canonical forms.

Counterpart of block2's MPSInfo<S> / MPS<S,FL> (reference
src/dmrg/mps.hpp:92,1656).  Bond StateInfos are FCI-bounded tensor products
filtered against target reachability (mps.hpp:609 set_bond_dimension), with
proportional per-sector allocation of the requested bond dimension.  Canonical
form is tracked with the same LCR letter convention; tensors are host-side
dict-of-blocks (core/blocks.py) — device arrays only materialize inside the
compiled sweep plans.

Copied from block2_preview_tpu/dmrg/mps.py (the port keeps its own copy).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..core.blocks import MPSTensor
from ..core.state_info import StateInfo
from ..core.symmetry import QN, SymmetryGroup


class MPSInfo:
    def __init__(self, group: SymmetryGroup, site_quanta: List[List[QN]],
                 target: QN, bond_dim: int):
        self.group = group
        self.site_quanta = site_quanta
        self.target = target
        self.bond_dim = bond_dim
        L = len(site_quanta)
        self.n_sites = L
        site_infos = [StateInfo(group, {q: sum(1 for x in qs if x == q)
                                        for q in qs})
                      for qs in site_quanta]
        self.site_infos = site_infos
        # FCI-bounded left/right bond spaces
        left = [StateInfo.vacuum(group)]
        for t in range(L):
            left.append(left[t].tensor_product(site_infos[t]))
        right = [None] * (L + 1)
        right[L] = StateInfo.single(group, target)
        for t in range(L - 1, -1, -1):
            # quanta q at bond t such that q + (some product of sites >= t) = target
            prod = StateInfo(group, {})
            for qp in site_infos[t]:
                for qr, nr in right[t + 1].items():
                    q = group.sub(qr, qp)
                    prod.quanta[q] = prod.quanta.get(q, 0) + \
                        site_infos[t][qp] * nr
            right[t] = StateInfo(group, prod.quanta)
        self.left_fci = left
        self.right_fci = right
        # allocated bond dims: min(left, right) then proportional truncation
        self.bonds: List[StateInfo] = []
        for t in range(L + 1):
            caps = {}
            for q, nl in left[t].items():
                nr = right[t].get(q, 0)
                if nr > 0:
                    caps[q] = min(nl, nr)
            self.bonds.append(
                StateInfo(group, caps).truncate_total(bond_dim))


class MPS:
    """Two-site-centered MPS: tensors[0..center-1] left-canonical,
    tensors[center+1..] right-canonical (canonical_form letters L..CC..R,
    matching reference mps.hpp:1661)."""

    def __init__(self, info: MPSInfo, tensors: List[MPSTensor], center: int = 0):
        self.info = info
        self.tensors = tensors
        self.center = center

    @property
    def group(self):
        return self.info.group

    @property
    def n_sites(self):
        return self.info.n_sites

    @staticmethod
    def random(info: MPSInfo, seed: int = 1234) -> "MPS":
        rng = np.random.RandomState(seed)
        g = info.group
        tensors = []
        for t in range(info.n_sites):
            blocks = {}
            # degenerate site quanta (trivial-symmetry qubits, big sites)
            # share one block with the multiplicity along the physical axis
            mult: Dict[QN, int] = {}
            for qp in info.site_quanta[t]:
                mult[qp] = mult.get(qp, 0) + 1
            for ql, dl in info.bonds[t].items():
                for qp, m in mult.items():
                    qr = g.add(ql, qp)
                    dr = info.bonds[t + 1].get(qr, 0)
                    if dr > 0:
                        blocks[(ql, qp, qr)] = rng.standard_normal((dl, m,
                                                                    dr))
            tensors.append(MPSTensor(g, blocks))
        mps = MPS(info, tensors, center=0)
        mps.canonicalize()
        return mps

    # -- canonicalization ------------------------------------------------
    def left_canonicalize_site(self, t: int) -> None:
        """QR at site t, push R into site t+1."""
        g = self.group
        T = self.tensors[t]
        by_qr: Dict[QN, List[Tuple[QN, QN, np.ndarray]]] = {}
        for (ql, qp, qr), b in T.blocks.items():
            by_qr.setdefault(qr, []).append((ql, qp, b))
        new_blocks = {}
        rmats: Dict[QN, np.ndarray] = {}
        for qr, items in by_qr.items():
            items.sort(key=lambda x: (x[0], x[1]))
            mats = [b.reshape(-1, b.shape[2]) for _, _, b in items]
            m = np.concatenate(mats, axis=0)
            q, r = np.linalg.qr(m)
            off = 0
            for (ql, qp, b) in items:
                rows = b.shape[0] * b.shape[1]
                new_blocks[(ql, qp, qr)] = q[off:off + rows].reshape(
                    b.shape[0], b.shape[1], -1)
                off += rows
            rmats[qr] = r
        self.tensors[t] = MPSTensor(g, new_blocks)
        if t + 1 < self.n_sites:
            Tn = self.tensors[t + 1]
            nb = {}
            for (ql, qp, qr), b in Tn.blocks.items():
                if ql in rmats:
                    r = rmats[ql]
                    nb[(ql, qp, qr)] = np.einsum(
                        "xl,lpr->xpr", r, b, optimize=True)
            self.tensors[t + 1] = MPSTensor(g, nb)

    def right_canonicalize_site(self, t: int) -> None:
        """LQ at site t, push L into site t-1."""
        g = self.group
        T = self.tensors[t]
        by_ql: Dict[QN, List[Tuple[QN, QN, np.ndarray]]] = {}
        for (ql, qp, qr), b in T.blocks.items():
            by_ql.setdefault(ql, []).append((qp, qr, b))
        new_blocks = {}
        lmats: Dict[QN, np.ndarray] = {}
        for ql, items in by_ql.items():
            items.sort(key=lambda x: (x[0], x[1]))
            mats = [b.reshape(b.shape[0], -1) for _, _, b in items]
            m = np.concatenate(mats, axis=1)
            q, r = np.linalg.qr(m.T)
            qt = q.T   # (k, cols) with qt @ qt.T = I
            off = 0
            for (qp, qr, b) in items:
                cols = b.shape[1] * b.shape[2]
                new_blocks[(ql, qp, qr)] = qt[:, off:off + cols].reshape(
                    -1, b.shape[1], b.shape[2])
                off += cols
            lmats[ql] = r.T   # (dl, k)
        self.tensors[t] = MPSTensor(g, new_blocks)
        if t - 1 >= 0:
            Tp = self.tensors[t - 1]
            nb = {}
            for (ql, qp, qr), b in Tp.blocks.items():
                if qr in lmats:
                    nb[(ql, qp, qr)] = np.einsum(
                        "lpr,rx->lpx", b, lmats[qr], optimize=True)
            self.tensors[t - 1] = MPSTensor(g, nb)

    def canonicalize(self) -> None:
        """Bring to right-canonical form with center at 0, normalized."""
        for t in range(self.n_sites - 1, 0, -1):
            self.right_canonicalize_site(t)
        self.center = 0
        nrm = self.tensors[0].norm()
        if nrm > 0:
            self.tensors[0] = self.tensors[0].scaled(1.0 / nrm)

    def bond_info_at(self, t: int) -> StateInfo:
        """Actual bond StateInfo at bond t derived from tensors."""
        g = self.group
        if t == 0:
            return StateInfo.vacuum(g)
        dims: Dict[QN, int] = {}
        for (ql, qp, qr), b in self.tensors[t - 1].blocks.items():
            dims[qr] = max(dims.get(qr, 0), b.shape[2])
        return StateInfo(g, dims)
