"""SU2 -> SZ: the exact expansion of a solved spin-adapted MPS.

Copied from block2_preview_tpu/utils/transform.py:1-50, 130-241 (the port
keeps its own copy; reference pyblock2/driver/core.py:7217 mps_change_symm
/ TransMPS): ``su2_to_sz_mps`` and its ``_SU2_MULTS`` / ``_SU2_STATES``
tables.  It is host numpy over the engine's reduced tensors, which the
port's SU2FermionDMRG keeps as numpy dicts; the one forward sweep it may
run first runs on the engine's own backend (K5 and K7 on the card).  The
SZ -> SGF transform (``sz_to_sgf_mps``) waits for the SGF mode (ROADMAP).

    drv = DMRGDriver(SymmetryTypes.SU2)
    ...
    drv.dmrg(mpo, ket, bond_dims=[100])
    sz = su2_to_sz_mps(ket.engine)          # 2Sz = 2S, the highest weight
    dm1 = DMRGDriver().get_1pdm(sz)         # or drv.get_1pdm(ket)
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..core.blocks import MPSTensor
from ..core.clebsch_gordan import clebsch_gordan
from ..core.symmetry import QN, SZ_GROUP
from ..dmrg.mps import MPS, MPSInfo
from ..ops.local_ops import sz_site_basis_quanta

__all__ = ["su2_to_sz_mps"]

_SU2_MULTS = [(0, 0), (1, 1), (2, 0)]
# multiplet -> [(SZ site-basis index, 2m)] in sz_site_basis_quanta order
_SU2_STATES = {0: [(0, 0)], 1: [(1, 1), (2, -1)], 2: [(3, 0)]}


def su2_to_sz_mps(engine, tjz: int = None) -> MPS:
    """Expand a solved spin-adapted MPS (SU2FermionDMRG) into an abelian SZ
    MPS for the *physical* 2Sz = tjz projection (default: highest weight).

    Singlet-embedded MPSs (engine.LV != vacuum, reference
    mps.hpp:1869 from_singlet_embedding_wfn semantics) are supported:
    the fictitious left boundary multiplet is fixed to the projection
    2m = T[1] - tjz and subtracted from every bond label afterwards, so
    the result is the physical non-embedded SZ component (its norm is
    the Clebsch-Gordan weight, 1/sqrt(2S+1) for a singlet embedding —
    normalize afterwards if a unit state is wanted).

    Requires the engine's stored tensors to be in left-fusion form with the
    center absorbed at the last site — i.e. the last completed sweep was a
    forward sweep (the plain per-vertex Clebsch-Gordan expansion then
    reproduces the m-resolved state exactly).  If the engine last swept
    backward, one extra forward sweep is run, on the engine's backend.
    Only the fermion site's three multiplets expand (ValueError otherwise).
    """
    for t, ms in enumerate(engine.mults):
        if [m[:2] for m in ms] != _SU2_MULTS:
            # custom SAnySU2 sites (t-J, spins) have no SZ site basis here
            raise ValueError(
                f"site {t} has the multiplets {ms}: the SU2 -> SZ expansion "
                f"takes the fermion site's {_SU2_MULTS} (N, 2S)")
    if engine._forward_next:   # last sweep was backward -> refresh
        engine.sweep(True, dav_thrd=1e-12)
    L = engine.L
    T = engine.T
    LV = tuple(getattr(engine, "LV", (0, 0, 0)))
    if tjz is None:
        tjz = T[1] if LV == (0, 0, 0) else LV[1]
    if LV == (0, 0, 0):
        assert abs(tjz) <= T[1] and (tjz - T[1]) % 2 == 0
        mz0 = 0
        tjz_tot = tjz
    else:
        tjz_tot = T[1]          # highest weight of the embedded total
        mz0 = tjz_tot - tjz     # fictitious-multiplet projection
        assert abs(mz0) <= LV[1] and (mz0 - LV[1]) % 2 == 0

    # SZ bond sector layouts: (N, mz, pg) -> [(su2 sector q, offset, dim)]
    def bond_layout(dims_su2):
        lay: Dict[QN, List] = {}
        for q in sorted(dims_su2):
            n, tj, pg = q
            d = dims_su2[q]
            for mz in range(-tj, tj + 1, 2):
                runs = lay.setdefault((n, mz, pg), [])
                off = sum(r[2] for r in runs)
                runs.append((q, off, d))
        return lay

    # per-bond SU2 sector dims from the tensors
    bond_dims: List[Dict] = [dict() for _ in range(L + 1)]
    bond_dims[0] = {LV: 1}
    for t in range(L):
        for (ql, m, qr), mat in engine.tensors[t].items():
            bond_dims[t].setdefault(ql, mat.shape[0])
            bond_dims[t + 1].setdefault(qr, mat.shape[1])
    layouts = [bond_layout(bd) for bd in bond_dims]
    # fix the boundaries: fictitious multiplet projection on the left,
    # requested total projection on the right
    layouts[0] = {(LV[0], mz0, LV[2]): [(LV, 0, 1)]}
    layouts[L] = {(T[0], tjz_tot, T[2]): [(T, 0, 1)]}

    # physical (non-embedded) labels: subtract the fictitious boundary
    def _phys(q):
        return (q[0] - LV[0], q[1] - mz0, q[2] ^ LV[2])

    target_phys = _phys((T[0], tjz_tot, T[2]))
    site_quanta = [sz_site_basis_quanta(int(p)) for p in engine.site_pgs]
    info = MPSInfo(SZ_GROUP, site_quanta, target_phys,
                   max(sum(r[2] for r in runs)
                       for lay in layouts for runs in lay.values()))
    tensors: List[MPSTensor] = []
    for t in range(L):
        blocks: Dict[Tuple, np.ndarray] = {}
        quanta = site_quanta[t]
        for (ql, m, qr), mat in engine.tensors[t].items():
            jl, jr = ql[1], qr[1]
            jm = _SU2_MULTS[m][1]
            for (sidx, tm) in _SU2_STATES[m]:
                qp = quanta[sidx]
                for ml in range(-jl, jl + 1, 2):
                    mr = ml + tm
                    if abs(mr) > jr:
                        continue
                    kl = (ql[0], ml, ql[2])
                    kr = (qr[0], mr, qr[2])
                    if kl not in layouts[t] or kr not in layouts[t + 1]:
                        continue
                    cg = clebsch_gordan(jl, jm, jr, ml, tm, mr)
                    if abs(cg) < 1e-14:
                        continue
                    off_l = next((o for (q2, o, _d) in layouts[t][kl]
                                  if q2 == ql), None)
                    off_r = next((o for (q2, o, _d) in layouts[t + 1][kr]
                                  if q2 == qr), None)
                    if off_l is None or off_r is None:
                        continue
                    dl_tot = sum(r[2] for r in layouts[t][kl])
                    dr_tot = sum(r[2] for r in layouts[t + 1][kr])
                    key = (_phys(kl), qp, _phys(kr))
                    blk = blocks.get(key)
                    if blk is None:
                        blk = np.zeros((dl_tot, 1, dr_tot))
                        blocks[key] = blk
                    blk[off_l:off_l + mat.shape[0], 0,
                        off_r:off_r + mat.shape[1]] += cg * mat
        tensors.append(MPSTensor(SZ_GROUP, blocks))
    return MPS(info, tensors, center=L - 1)
