"""Linear sweeps: MPS compression, MPO x MPS fitting, and MPS addition.

Copied from block2_preview_tpu/dmrg/linear.py:29-159 (reference
src/dmrg/sweep_algorithm.hpp:3270: |x> ~ c|b> compression, |x> ~ M|b>
multiplication fitting, FitAddition), as the port's driver uses it in
compress_mps / multiply / addition and to build the right-hand side of a
Green's function (reference pyblock2/driver/core.py:6300, 6506, 6702).

The bra |x> is optimized two sites at a time: the local update is the
mixed-basis effective operator applied to the ket center wavefunction
(rhs = sum_i c_i * M_i |b_i> projected into x's bases), followed by the
density-matrix decimation of the DMRG sweep.  It runs on the host, as in
the reference: host environments (``MovingEnvironment(mpo, ket, bra=)``),
host LW/RW and host products; no kernel of the port runs here.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.symmetry import QN
from .effective import EffectiveHamiltonian2, Key2
from .environment import MovingEnvironment
from .mpo import MPO
from .mps import MPS, MPSTensor
from .sweep import _decimate


def identity_mpo(template: MPO) -> MPO:
    """Identity MPO on the same site bases (reference qc_mpo.hpp:41
    IdentityMPO)."""
    g = template.group
    L = template.n_sites
    tensors = []
    for t in range(L):
        d = len(template.site_quanta[t])
        tensors.append({(0, 0): np.eye(d)})
    return MPO(group=g, n_sites=L, site_quanta=template.site_quanta,
               bond_dqs=[[g.zero]] * (L + 1), tensors=tensors, const_e=0.0)


class Linear:
    """Fit |x> ~ sum_i coeff_i * M_i |b_i> by alternating 2-site sweeps."""

    def __init__(self, bra: MPS, terms: Sequence[Tuple[MPO, MPS]],
                 coeffs: Optional[Sequence[float]] = None, iprint: int = 0):
        self.bra = bra
        self.terms = list(terms)
        self.coeffs = list(coeffs) if coeffs is not None \
            else [1.0] * len(self.terms)
        self.iprint = iprint
        self.mes = []
        for mpo, ket in self.terms:
            me = MovingEnvironment(mpo, ket, bra=bra)
            me.init_environments()
            self.mes.append(me)
        self.values: List[float] = []

    def update_two_dot(self, t: int, forward: bool, bond_dim: int
                       ) -> float:
        effs = [EffectiveHamiltonian2(me, t) for me in self.mes]
        space = effs[0].bra_space
        dt = np.result_type(np.float64,
                            *[eff.dtype for eff in effs],
                            *[np.asarray(c).dtype for c in self.coeffs])
        rhs: Dict[Key2, np.ndarray] = {k: np.zeros(space.shapes[k], dtype=dt)
                                       for k in space.keys}
        for c, eff in zip(self.coeffs, effs):
            psi_k = eff.initial_guess()
            out = eff.matvec_blocks(psi_k)
            for k, b in out.items():
                rhs[k] += c * b
        nrm = np.sqrt(abs(sum(np.sum(b * np.conj(b))
                              for b in rhs.values())))
        g = effs[0].g
        target = self.bra.info.target
        if nrm > 1e-300:
            psi = {k: b / nrm for k, b in rhs.items()}
        else:
            psi = rhs
        fl, fr = space.fl, space.fr

        if forward:
            rho: Dict[QN, np.ndarray] = {}
            for (qL, qR), b in psi.items():
                acc = rho.get(qL)
                rho[qL] = b @ b.T if acc is None else acc + b @ b.T
            rot, dw = _decimate(rho, bond_dim)
            a_blocks = {}
            for qL, vmat in rot.items():
                for (ql, qp, off, dl, dp) in fl.maps[qL]:
                    a_blocks[(ql, qp, qL)] = vmat[off:off + dl * dp, :] \
                        .reshape(dl, dp, -1)
            c_blocks: Dict[Tuple[QN, QN, QN], np.ndarray] = {}
            for qL, vmat in rot.items():
                qR = g.sub(target, qL)
                if (qL, qR) not in psi:
                    continue
                mmat = vmat.T @ (psi[(qL, qR)] * nrm)
                for (qp, qc2, off, dp, db) in fr.maps[qR]:
                    qr2 = g.sub(target, qc2)
                    blk = mmat[:, off:off + dp * db].reshape(-1, dp, db)
                    key = (qL, qp, qr2)
                    c_blocks[key] = c_blocks.get(key, 0) + blk
            self.bra.tensors[t] = MPSTensor(g, a_blocks)
            self.bra.tensors[t + 1] = MPSTensor(g, c_blocks)
            for me in self.mes:
                me.update_left(t)
                me.invalidate_right(t + 1)
        else:
            rho = {}
            for (qL, qR), b in psi.items():
                acc = rho.get(qR)
                rho[qR] = b.T @ b if acc is None else acc + b.T @ b
            rot, dw = _decimate(rho, bond_dim)
            b_blocks = {}
            for qR, vmat in rot.items():
                ql_new = g.sub(target, qR)
                for (qp, qc2, off, dp, db) in fr.maps[qR]:
                    qr2 = g.sub(target, qc2)
                    b_blocks[(ql_new, qp, qr2)] = \
                        vmat[off:off + dp * db, :].T.reshape(-1, dp, db)
            c_blocks = {}
            for qR, vmat in rot.items():
                qL = g.sub(target, qR)
                if (qL, qR) not in psi:
                    continue
                mmat = (psi[(qL, qR)] * nrm) @ vmat
                for (ql, qp, off, dl, dp) in fl.maps[qL]:
                    blk = mmat[off:off + dl * dp, :].reshape(dl, dp, -1)
                    key = (ql, qp, qL)
                    c_blocks[key] = c_blocks.get(key, 0) + blk
            self.bra.tensors[t + 1] = MPSTensor(g, b_blocks)
            self.bra.tensors[t] = MPSTensor(g, c_blocks)
            for me in self.mes:
                me.update_right(t + 1)
                me.invalidate_left(t)
        return float(nrm)

    def solve(self, bond_dim: int, n_sweeps: int = 10,
              tol: float = 1e-10) -> float:
        L = self.bra.n_sites
        forward = True
        last = np.inf
        val = 0.0
        for isw in range(n_sweeps):
            rng = range(L - 1) if forward else range(L - 2, -1, -1)
            vals = [self.update_two_dot(t, forward, bond_dim) for t in rng]
            val = vals[-1]
            if self.iprint >= 1:
                print(f"linear sweep {isw:3d} {'F' if forward else 'B'} "
                      f"|rhs| = {val:.12f}")
            if abs(val - last) < tol * max(abs(val), 1.0):
                break
            last = val
            forward = not forward
        self.values.append(val)
        return val
