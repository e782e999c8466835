"""State-specific projection: the local images of previously converged MPSs.

Copied from block2_preview_tpu/dmrg/projection.py (``OverlapEnvs``, :24)
and cut to the two-site sweep of the port (``two_dot_vector``; the
one-site vectors are not carried).  Reference analog: DMRG::proj_mpss /
proj_weights (src/dmrg/sweep_algorithm.hpp:96-133; block2main keywords
proj_mps_tags / proj_weights): per sweep site the projector MPS is
compressed into the current two-site space through identity-overlap
environments, and the local eigensolve projects it out (or adds the
penalty w_i |v_i><v_i|, ``ops/davidson.py``).  The overlap environments
are small and stay on the host, as in the reference.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.symmetry import QN
from .mps import MPS

EnvBlocks = Dict[Tuple[QN, QN], np.ndarray]


class OverlapEnvs:
    """Identity-MPO overlap environments <mps | phi> per bond, updated
    lazily as the sweep rewrites mps tensors (the MovingEnvironment of a
    projector, reference parallel to moving_environment.hpp with the
    identity MPO)."""

    def __init__(self, mps: MPS, phi: MPS, weight: float):
        self.mps = mps
        self.phi = phi
        self.weight = float(weight)
        g = mps.group
        self.g = g
        L = mps.n_sites
        self.lo: List[Optional[EnvBlocks]] = [None] * (L + 1)
        self.ro: List[Optional[EnvBlocks]] = [None] * (L + 1)
        self.lo[0] = {(g.zero, g.zero): np.ones((1, 1))}
        tb, tk = mps.info.target, phi.info.target
        self.ro[L] = {(tb, tk): np.ones((1, 1))} if tb == tk else {}
        self._lval = 0       # lo[0.._lval] valid
        self._rval = L       # ro[_rval..L] valid

    # -- transfers ----------------------------------------------------
    def _transfer_left(self, e: EnvBlocks, t: int) -> EnvBlocks:
        out: EnvBlocks = {}
        pby: Dict[Tuple[QN, QN], List] = {}
        for (ql, qp, qr), b in self.phi.tensors[t].blocks.items():
            pby.setdefault((ql, qp), []).append((qr, b))
        for (ql, qp, qr), b in self.mps.tensors[t].blocks.items():
            a = b.conj()
            for (qb, qk), eb in e.items():
                if qb != ql:
                    continue
                for qr2, ph in pby.get((qk, qp), []):
                    # [Dr_ours, Dr_phi] = A^*[(l p) r]^T E[l, k] phi[(k p) s]
                    c = np.einsum("lpr,lk,kps->rs", a, eb, ph,
                                  optimize=True)
                    key = (qr, qr2)
                    if key in out:
                        out[key] += c
                    else:
                        out[key] = c
        return out

    def _transfer_right(self, e: EnvBlocks, t: int) -> EnvBlocks:
        out: EnvBlocks = {}
        pby: Dict[Tuple[QN, QN], List] = {}
        for (ql, qp, qr), b in self.phi.tensors[t].blocks.items():
            pby.setdefault((qr, qp), []).append((ql, b))
        for (ql, qp, qr), b in self.mps.tensors[t].blocks.items():
            a = b.conj()
            for (qb, qk), eb in e.items():
                if qb != qr:
                    continue
                for ql2, ph in pby.get((qk, qp), []):
                    c = np.einsum("lpr,rs,kps->lk", a, eb, ph,
                                  optimize=True)
                    key = (ql, ql2)
                    if key in out:
                        out[key] += c
                    else:
                        out[key] = c
        return out

    # -- lazy validity ------------------------------------------------
    def ensure_lo(self, t: int) -> EnvBlocks:
        while self._lval < t:
            self.lo[self._lval + 1] = self._transfer_left(
                self.lo[self._lval], self._lval)
            self._lval += 1
        return self.lo[t]

    def ensure_ro(self, b: int) -> EnvBlocks:
        while self._rval > b:
            self._rval -= 1
            self.ro[self._rval] = self._transfer_right(
                self.ro[self._rval + 1], self._rval)
        return self.ro[b]

    def dirty(self, t_lo: int, t_hi: int) -> None:
        """Tensors at sites t_lo..t_hi were rewritten."""
        self._lval = min(self._lval, t_lo)
        self._rval = max(self._rval, t_hi + 1)

    # -- local projector vector ---------------------------------------
    def two_dot_vector(self, eff) -> np.ndarray:
        """phi compressed into eff's two-site fused ket space (flat)."""
        g = self.g
        t = eff.t
        lo = self.ensure_lo(t)
        ro = self.ensure_ro(t + 2)
        space = eff.ket_space
        target = self.mps.info.target
        v = {k: np.zeros(space.shapes[k]) for k in space.keys}
        rby: Dict[QN, List] = {}
        for (qm2, qp2, qr2), b in self.phi.tensors[t + 1].blocks.items():
            rby.setdefault(qm2, []).append((qp2, qr2, b))
        lo_by: Dict[QN, List] = {}
        for (qb, qk), m in lo.items():
            lo_by.setdefault(qk, []).append((qb, m))
        ro_by: Dict[QN, List] = {}
        for (qb, qk), m in ro.items():
            ro_by.setdefault(qk, []).append((qb, m))
        for (ql2, qp1, qm2), bl in self.phi.tensors[t].blocks.items():
            for (qb_l, lom) in lo_by.get(ql2, []):
                qL = g.add(qb_l, qp1)
                qR = g.sub(target, qL)
                if (qL, qR) not in space.offsets:
                    continue
                for (qp2, qr2, br) in rby.get(qm2, []):
                    for (qb_r, rom) in ro_by.get(qr2, []):
                        qc2 = g.sub(target, qb_r)
                        if g.add(qp2, qc2) != qR:
                            continue
                        try:
                            lofs, _dl, _dp = space.fl.sub_offset(
                                qL, qb_l, qp1)
                            rofs, _dp2, _db = space.fr.sub_offset(
                                qR, qp2, qc2)
                        except KeyError:
                            continue
                        mat = np.einsum("ab,bpm,mqr,cr->apqc", lom, bl,
                                        br, rom, optimize=True)
                        da, dp_, dq_, dc_ = mat.shape
                        v[(qL, qR)][lofs:lofs + da * dp_,
                                    rofs:rofs + dq_ * dc_] += \
                            mat.reshape(da * dp_, dq_ * dc_)
        return space.flatten(v)
