"""Two-site effective Hamiltonian: fused bases, complementary-operator pairs,
sigma-vector contraction, and density-matrix decimation.

TPU-native counterpart of block2's EffectiveHamiltonian (reference
src/dmrg/effective_hamiltonian.hpp:98: ConnectionInfo precompute + operator()
sigma-vector at :449, eigs at :471) and the density-matrix/split helpers in
MovingEnvironment (reference src/dmrg/moving_environment.hpp: density_matrix,
split_density_matrix).

The effective operator is assembled as H = sum_m LW[m] (x) RW[m], where m runs
over the MPO symbols of the center bond: LW[m] acts on the fused
(left bond (x) site t) basis and RW[m] on the fused (site t+1 (x) right
complement) basis.  This is exactly block2's left/right complementary-operator
factorization (DelayedOperatorTensor, reference src/core/operator_tensor.hpp:209);
the list of matching (LW block, psi block, RW block) GEMM triples is the
static contraction plan that the device executor buckets into batched matmuls.

Supports bra != ket (mixed bases): the operator then maps ket-space vectors to
bra-space vectors — the engine behind compression / MPO-fitting / linear
solves (the reference's Linear sweep, sweep_algorithm.hpp:3270).

Copied from block2_preview_tpu/dmrg/effective.py: EffectiveHamiltonian2,
EffectiveHamiltonian1 (:414-583, the one-site back-evolution operator
of two-site TDVP and the forward one-site sweep's operator) and the
right-fused EffectiveHamiltonian1R (:584-741, the backward one-site
sweep's).  The host assembly runs from host environment maps; on
the resident device path the two-site operators are assembled on the card
(ops/resident.ResidentSite) and EffectiveHamiltonian2 only supplies the
sector spaces.

Charge conventions: a psi sector is (qL, qR) with qL + qR = target; qL is the
accumulated charge of sites <= t and qR the charge of sites >= t+1 (bond
quanta of the right half are stored complemented: qc = target - q_bond).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..ops.blocking import assemble_fused_ops
from ..core.blocks import FusedBasis
from ..core.state_info import StateInfo
from ..core.symmetry import QN
from .environment import MovingEnvironment
from .mpo import MPO
from .mps import MPS

Key2 = Tuple[QN, QN]


def _fused_bases(mps: MPS, t: int, target: QN):
    g = mps.group
    L = mps.n_sites
    bond_l = mps.bond_info_at(t)
    if t + 2 == L:
        bond_r = StateInfo.single(g, target)
    else:
        dims: Dict[QN, int] = {}
        for (ql, qp, qr), b in mps.tensors[t + 2].blocks.items():
            dims[ql] = max(dims.get(ql, 0), b.shape[0])
        bond_r = StateInfo(g, dims)
    site_l = mps.info.site_infos[t]
    site_r = mps.info.site_infos[t + 1]
    comp_r = StateInfo(g, {g.sub(target, q): d for q, d in bond_r.items()})
    return FusedBasis(g, bond_l, site_l), FusedBasis(g, site_r, comp_r)


class _Space:
    """Sector keys / shapes / flat offsets of a two-site wavefunction space."""

    def __init__(self, g, fl: FusedBasis, fr: FusedBasis, target: QN):
        self.fl, self.fr = fl, fr
        self.keys: List[Key2] = []
        for qL in fl.sectors():
            qR = g.sub(target, qL)
            if qR in fr.maps:
                self.keys.append((qL, qR))
        self.keys.sort()
        self.shapes = {(qL, qR): (fl.info[qL], fr.info[qR])
                       for (qL, qR) in self.keys}
        self.offsets: Dict[Key2, int] = {}
        off = 0
        for k in self.keys:
            self.offsets[k] = off
            dl, dr = self.shapes[k]
            off += dl * dr
        self.size = off

    def flatten(self, blocks: Dict[Key2, np.ndarray],
                dtype=np.float64) -> np.ndarray:
        x = np.zeros(self.size, dtype=dtype)
        for k, b in blocks.items():
            if k in self.offsets:
                off = self.offsets[k]
                x[off:off + b.size] = b.ravel()
        return x

    def unflatten(self, x: np.ndarray) -> Dict[Key2, np.ndarray]:
        out = {}
        for k in self.keys:
            dl, dr = self.shapes[k]
            off = self.offsets[k]
            out[k] = x[off:off + dl * dr].reshape(dl, dr)
        return out


class EffectiveHamiltonian2:
    def __init__(self, me: MovingEnvironment, t: int,
                 assemble: bool = True):
        self.me = me
        self.t = t
        mpo, ket, bra = me.mpo, me.ket, me.bra
        g = mpo.group
        self.g = g
        self.target = ket.info.target
        L = mpo.n_sites
        assert 0 <= t < L - 1
        self.mixed = bra is not ket

        # dtype: complex if MPO entries, site tensors or environments are
        # complex
        dt = np.float64
        for w in (mpo.tensors[t], mpo.tensors[t + 1]):
            for blk in w.values():
                dt = np.result_type(dt, blk.dtype)
        for T in (ket.tensors[t], ket.tensors[t + 1]):
            for b in T.blocks.values():
                dt = np.result_type(dt, b.dtype)
                break
        # host environment maps: a complex bra makes them complex against a
        # real ket and MPO (device pools, read without unpacking, are real)
        for env in (list.__getitem__(me.left_envs, t),
                    list.__getitem__(me.right_envs, t + 2)):
            if isinstance(env, dict):
                for bm in env.values():
                    for b in bm.blocks.values():
                        dt = np.result_type(dt, b.dtype)
                        break
                    break
        self.dtype = dt

        flk, frk = _fused_bases(ket, t, self.target)
        self.ket_space = _Space(g, flk, frk, self.target)
        if self.mixed:
            flb, frb = _fused_bases(bra, t, bra.info.target)
            self.bra_space = _Space(g, flb, frb, bra.info.target)
        else:
            self.bra_space = self.ket_space

        # backwards-compatible aliases (bra == ket case)
        self.fl, self.fr = flk, frk
        self.psi_keys = self.ket_space.keys
        self.shapes = self.ket_space.shapes
        self.offsets = self.ket_space.offsets
        self.size = self.ket_space.size

        if assemble:
            self._assemble(t)
            self._build_triples()
        else:
            # spaces-only mode: the device-resident pipeline
            # (ops/resident.ResidentSite) assembles LW/RW on the
            # accelerator; host LW/RW stay unmaterialized
            self.LW = self.RW = None
            self.triples = None

    def ensure_assembled(self) -> None:
        """Materialize host LW/RW/triples on demand (noise term, host
        fallbacks) when built with assemble=False."""
        if self.LW is None:
            self._assemble(self.t)
            self._build_triples()

    # ------------------------------------------------------------------
    def _assemble(self, t: int) -> None:
        """Assemble LW[m]/RW[m] block operators on the fused bases from the
        host environment maps."""
        g, mpo, me = self.g, self.me.mpo, self.me
        env_l = me.left_envs[t]
        env_r = me.right_envs[t + 2]
        assert env_l is not None and env_r is not None
        tk = self.target
        tb = self.me.bra.info.target if self.mixed else tk
        flb, frb = self.bra_space.fl, self.bra_space.fr
        flk, frk = self.ket_space.fl, self.ket_space.fr
        active_lb = {qL for (qL, _) in self.bra_space.keys}
        active_rb = {qR for (_, qR) in self.bra_space.keys}
        active_lk = {qL for (qL, _) in self.ket_space.keys}
        active_rk = {qR for (_, qR) in self.ket_space.keys}
        if not hasattr(me, "_asm_cache"):
            me._asm_cache = {}
        self.LW = assemble_fused_ops(
            env_l, mpo.tensors[t], mpo.site_quanta[t], flb,
            bond_is_first=True, join_on_input=True, group=g,
            active=active_lb, fused_ket=flk, active_ket=active_lk,
            dtype=self.dtype, plan_cache=me._asm_cache, plan_key=(t, "lw"))
        self.RW = assemble_fused_ops(
            env_r, mpo.tensors[t + 1], mpo.site_quanta[t + 1], frb,
            bond_is_first=False, join_on_input=False, comp_target=tb,
            group=g, active=active_rb, fused_ket=frk,
            comp_target_ket=tk, active_ket=active_rk, dtype=self.dtype,
            plan_cache=me._asm_cache, plan_key=(t, "rw"))

    def _build_triples(self) -> None:
        """Static contraction plan: (m, LW block key, psi key, RW block key,
        out psi key) for every nonvanishing sigma contribution."""
        g = self.g
        tk = self.target
        tb = self.me.bra.info.target if self.mixed else tk
        triples = []
        for m, lw in self.LW.items():
            rw = self.RW.get(m)
            if rw is None:
                continue
            for (qLb, qLk) in lw:
                qRk = g.sub(tk, qLk)
                qRb = g.sub(tb, qLb)
                if (qLk, qRk) not in self.ket_space.shapes:
                    continue
                if (qRb, qRk) in rw and (qLb, qRb) in self.bra_space.shapes:
                    triples.append((m, (qLb, qLk), (qLk, qRk),
                                    (qRb, qRk), (qLb, qRb)))
        self.triples = triples

    # ------------------------------------------------------------------
    def flatten(self, blocks: Dict[Key2, np.ndarray]) -> np.ndarray:
        dt = np.result_type(np.float64,
                            *(b.dtype for b in blocks.values())) \
            if blocks else np.float64
        return self.ket_space.flatten(blocks, dtype=dt)

    def unflatten(self, x: np.ndarray) -> Dict[Key2, np.ndarray]:
        return self.ket_space.unflatten(x)

    # ------------------------------------------------------------------
    def matvec_blocks(self, psi: Dict[Key2, np.ndarray]
                      ) -> Dict[Key2, np.ndarray]:
        dt = np.result_type(self.dtype,
                            *(b.dtype for b in psi.values())) \
            if psi else self.dtype
        sig = {k: np.zeros(self.bra_space.shapes[k], dtype=dt)
               for k in self.bra_space.keys}
        for (m, lk, pk, rk, ok) in self.triples:
            sig[ok] += self.LW[m][lk] @ psi[pk] @ self.RW[m][rk].T
        return sig

    def matvec_np(self, x: np.ndarray) -> np.ndarray:
        psi = self.ket_space.unflatten(x)
        return self.bra_space.flatten(self.matvec_blocks(psi),
                                      dtype=np.result_type(self.dtype,
                                                           x.dtype))

    def diagonal(self) -> np.ndarray:
        assert not self.mixed
        diag = {k: np.zeros(self.shapes[k]) for k in self.psi_keys}
        # (diagonal of a Hermitian operator is real)
        for m, lw in self.LW.items():
            rw = self.RW.get(m)
            if rw is None:
                continue
            for (qL, qR) in self.psi_keys:
                lb = lw.get((qL, qL))
                rb = rw.get((qR, qR))
                if lb is not None and rb is not None:
                    diag[(qL, qR)] += (np.diag(lb)[:, None]
                                       * np.diag(rb)[None, :]).real
        return self.flatten(diag)

    # ------------------------------------------------------------------
    def initial_guess(self, tensor_l=None, tensor_r=None, use_bra=False
                      ) -> Dict[Key2, np.ndarray]:
        """psi from contracting MPS tensors at t, t+1 into the fused bases.
        tensor_l/tensor_r override the site tensors (per-root centers for
        state-averaged sweeps, MultiMPS analog)."""
        g = self.g
        mps = self.me.bra if use_bra else self.me.ket
        space = self.bra_space if use_bra else self.ket_space
        target = mps.info.target
        Tl = tensor_l if tensor_l is not None else mps.tensors[self.t]
        Tr = tensor_r if tensor_r is not None else mps.tensors[self.t + 1]
        dt = np.float64
        for T in (Tl, Tr):
            for b in T.blocks.values():
                dt = np.result_type(dt, b.dtype)
                break
        psi = {k: np.zeros(space.shapes[k], dtype=dt) for k in space.keys}
        rby: Dict[QN, List] = {}
        for (qm, qp, qr2), b in Tr.blocks.items():
            rby.setdefault(qm, []).append((qp, qr2, b))
        for (ql, qp, qm), bl in Tl.blocks.items():
            qL = g.add(ql, qp)
            if g.sub(target, qL) not in space.fr.maps:
                continue
            for (qp2, qr2, br) in rby.get(qm, []):
                qR = g.sub(target, qL)
                qc2 = g.sub(target, qr2)
                try:
                    lo, dl, dp = space.fl.sub_offset(qL, ql, qp)
                    ro, dp2, db = space.fr.sub_offset(qR, qp2, qc2)
                except KeyError:
                    continue
                if (qL, qR) not in psi:
                    continue
                mat = np.einsum("lpm,mqr->lpqr", bl, br, optimize=True)
                dl_, dp_, dq_, dr_ = mat.shape
                psi[(qL, qR)][lo:lo + dl_ * dp_, ro:ro + dq_ * dr_] += \
                    mat.reshape(dl_ * dp_, dq_ * dr_)
        return psi


class EffectiveHamiltonian1:
    """One-site effective Hamiltonian at site s, built from E_L[s], W_s, and
    E_R[s+1] — the back-evolution operator of two-site TDVP (reference
    src/dmrg/sweep_algorithm_td.hpp:794 TimeEvolution 1-site steps) and the
    single-site update operator of 1-site DMRG.

    The one-site center tensor C[(qm, qp, qr2)] is viewed as a matrix between
    the fused (bond_s (x) site_s) basis and the complemented bond_{s+1} basis;
    sigma = sum_m LW[m] psi RW[m]^T with RW[m] = E_R[s+1][m] relabeled.
    """

    def __init__(self, me: MovingEnvironment, s: int):
        self.me = me
        self.s = s
        mpo, ket = me.mpo, me.ket
        g = mpo.group
        self.g = g
        self.target = ket.info.target
        env_l = me.left_envs[s]
        env_r = me.right_envs[s + 1]
        assert env_l is not None and env_r is not None

        bond_l = ket.bond_info_at(s)
        # bond s+1 basis from the current center tensor's right index
        dims: Dict[QN, int] = {}
        for (ql, qp, qr), b in ket.tensors[s].blocks.items():
            dims[qr] = max(dims.get(qr, 0), b.shape[2])
        bond_r = StateInfo(g, dims)
        comp_r = StateInfo(g, {g.sub(self.target, q): d
                               for q, d in bond_r.items()})
        self.fl = FusedBasis(g, bond_l, ket.info.site_infos[s])
        self.comp_r = comp_r

        # dtype
        dt = np.float64
        for w in (mpo.tensors[s],):
            for blk in w.values():
                dt = np.result_type(dt, blk.dtype)
        for env in (env_l, env_r):
            for bm in env.values():
                for b in bm.blocks.values():
                    dt = np.result_type(dt, b.dtype)
                    break
                break
        for b in ket.tensors[s].blocks.values():
            dt = np.result_type(dt, b.dtype)
            break
        self.dtype = dt

        # sector keys
        self.keys: List[Key2] = []
        for qL in self.fl.sectors():
            qc = g.sub(self.target, qL)
            if qc in comp_r:
                self.keys.append((qL, qc))
        self.keys.sort()
        self.shapes = {(qL, qc): (self.fl.info[qL], comp_r[qc])
                       for (qL, qc) in self.keys}
        self.offsets: Dict[Key2, int] = {}
        off = 0
        for k in self.keys:
            self.offsets[k] = off
            dl, dr = self.shapes[k]
            off += dl * dr
        self.size = off

        active_l = {qL for (qL, _) in self.keys}
        active_r = {qc for (_, qc) in self.keys}
        quanta = mpo.site_quanta[s]

        # degenerate-quanta-safe vectorized assembly
        LW = assemble_fused_ops(
            env_l, mpo.tensors[s], quanta, self.fl, bond_is_first=True,
            join_on_input=True, group=g, active=active_l,
            fused_ket=self.fl, active_ket=active_l, dtype=self.dtype)
        RW: Dict[int, Dict[Key2, np.ndarray]] = {}
        for m, bm in env_r.items():
            dm = RW.setdefault(m, {})
            for (qb2, qk2), eb in bm.blocks.items():
                qcb = g.sub(self.target, qb2)
                qck = g.sub(self.target, qk2)
                if qcb in active_r and qck in active_r:
                    dm[(qcb, qck)] = eb
        self.LW, self.RW = LW, RW

        triples = []
        for m, lw in self.LW.items():
            rw = self.RW.get(m)
            if rw is None:
                continue
            for (qLb, qLk) in lw:
                qck = g.sub(self.target, qLk)
                qcb = g.sub(self.target, qLb)
                if (qLk, qck) in self.offsets and (qcb, qck) in rw \
                        and (qLb, qcb) in self.offsets:
                    triples.append((m, (qLb, qLk), (qLk, qck),
                                    (qcb, qck), (qLb, qcb)))
        self.triples = triples

    # ------------------------------------------------------------------
    def tensor_to_vec(self, T) -> np.ndarray:
        g = self.g
        dt = self.dtype
        for b in T.blocks.values():
            dt = np.result_type(dt, b.dtype)
        x = np.zeros(self.size, dtype=dt)
        for (ql, qp, qr2), b in T.blocks.items():
            qL = g.add(ql, qp)
            qc = g.sub(self.target, qr2)
            key = (qL, qc)
            if key not in self.offsets:
                continue
            off = self.offsets[key]
            dl, dr = self.shapes[key]
            so, d1, d2 = self.fl.sub_offset(qL, ql, qp)
            mat = b.reshape(-1, b.shape[2])
            base = off + so * dr
            x[base:base + mat.size] = mat.ravel()
        return x

    def vec_to_tensor(self, x: np.ndarray):
        from .mps import MPSTensor
        g = self.g
        blocks = {}
        for key in self.keys:
            qL, qc = key
            off = self.offsets[key]
            dl, dr = self.shapes[key]
            mat = x[off:off + dl * dr].reshape(dl, dr)
            qr2 = g.sub(self.target, qc)
            for (ql, qp, so, d1, d2) in self.fl.maps[qL]:
                blocks[(ql, qp, qr2)] = \
                    mat[so:so + d1 * d2, :].reshape(d1, d2, dr)
        return MPSTensor(g, blocks)

    def matvec_np(self, x: np.ndarray) -> np.ndarray:
        psi = {}
        for k in self.keys:
            dl, dr = self.shapes[k]
            off = self.offsets[k]
            psi[k] = x[off:off + dl * dr].reshape(dl, dr)
        dt = np.result_type(self.dtype, x.dtype)
        out = np.zeros(self.size, dtype=dt)
        for (m, lk, pk, rk, ok) in self.triples:
            contrib = self.LW[m][lk] @ psi[pk] @ self.RW[m][rk].T
            off = self.offsets[ok]
            out[off:off + contrib.size] += contrib.ravel()
        return out

    def diagonal(self) -> np.ndarray:
        diag = np.zeros(self.size)
        for m, lw in self.LW.items():
            rw = self.RW.get(m)
            if rw is None:
                continue
            for (qL, qc) in self.keys:
                lb = lw.get((qL, qL))
                rb = rw.get((qc, qc))
                if lb is not None and rb is not None:
                    off = self.offsets[(qL, qc)]
                    dl, dr = self.shapes[(qL, qc)]
                    d2 = (np.diag(lb)[:, None] * np.diag(rb)[None, :]).real
                    diag[off:off + dl * dr] += d2.ravel()
        return diag


class EffectiveHamiltonian1R:
    """Right-fused one-site effective Hamiltonian at site s: the center is a
    matrix between the plain bond_s basis and the fused (site_s (x) bond_{s+1})
    complement basis (block2's FuseTypes::FuseR, reference
    effective_hamiltonian.hpp:42).  Used by backward one-site sweeps."""

    def __init__(self, me: MovingEnvironment, s: int):
        self.me = me
        self.s = s
        mpo, ket = me.mpo, me.ket
        g = mpo.group
        self.g = g
        self.target = ket.info.target
        env_l = me.left_envs[s]
        env_r = me.right_envs[s + 1]
        assert env_l is not None and env_r is not None

        bond_l = ket.bond_info_at(s)
        dims: Dict[QN, int] = {}
        for (ql, qp, qr), b in ket.tensors[s].blocks.items():
            dims[qr] = max(dims.get(qr, 0), b.shape[2])
        bond_r = StateInfo(g, dims)
        comp_r = StateInfo(g, {g.sub(self.target, q): d
                               for q, d in bond_r.items()})
        self.bond_l = bond_l
        self.fr = FusedBasis(g, ket.info.site_infos[s], comp_r)

        dt = np.float64
        for blk in mpo.tensors[s].values():
            dt = np.result_type(dt, blk.dtype)
        for env in (env_l, env_r):
            for bm in env.values():
                for b in bm.blocks.values():
                    dt = np.result_type(dt, b.dtype)
                    break
                break
        for b in ket.tensors[s].blocks.values():
            dt = np.result_type(dt, b.dtype)
            break
        self.dtype = dt

        self.keys: List[Key2] = []
        for qb in bond_l:
            qRf = g.sub(self.target, qb)
            if qRf in self.fr.maps:
                self.keys.append((qb, qRf))
        self.keys.sort()
        self.shapes = {(qb, qRf): (bond_l[qb], self.fr.info[qRf])
                       for (qb, qRf) in self.keys}
        self.offsets: Dict[Key2, int] = {}
        off = 0
        for k in self.keys:
            self.offsets[k] = off
            dl, dr = self.shapes[k]
            off += dl * dr
        self.size = off

        active_l = {qb for (qb, _) in self.keys}
        active_r = {qRf for (_, qRf) in self.keys}
        quanta = mpo.site_quanta[s]

        # LW[m] = E_L[s][m] directly
        LW: Dict[int, Dict[Key2, np.ndarray]] = {}
        for m, bm in env_l.items():
            dm = LW.setdefault(m, {})
            for (qb2, qk2), eb in bm.blocks.items():
                if qb2 in active_l and qk2 in active_l:
                    dm[(qb2, qk2)] = eb
        # RW[m] assembled from W_s and E_R[s+1] on the right-fused basis
        RW = assemble_fused_ops(
            env_r, mpo.tensors[s], quanta, self.fr, bond_is_first=False,
            join_on_input=False, comp_target=self.target, group=g,
            active=active_r, fused_ket=self.fr,
            comp_target_ket=self.target, active_ket=active_r,
            dtype=self.dtype)
        self.LW, self.RW = LW, RW

        triples = []
        for m, lw in self.LW.items():
            rw = self.RW.get(m)
            if rw is None:
                continue
            for (qbb, qbk) in lw:
                qRk = g.sub(self.target, qbk)
                qRb = g.sub(self.target, qbb)
                if (qbk, qRk) in self.offsets and (qRb, qRk) in rw \
                        and (qbb, qRb) in self.offsets:
                    triples.append((m, (qbb, qbk), (qbk, qRk),
                                    (qRb, qRk), (qbb, qRb)))
        self.triples = triples

    # ------------------------------------------------------------------
    def tensor_to_vec(self, T) -> np.ndarray:
        g = self.g
        dt = self.dtype
        for b in T.blocks.values():
            dt = np.result_type(dt, b.dtype)
        x = np.zeros(self.size, dtype=dt)
        for (ql, qp, qr2), b in T.blocks.items():
            qRf = g.add(qp, g.sub(self.target, qr2))
            key = (ql, qRf)
            if key not in self.offsets:
                continue
            off = self.offsets[key]
            dl, dr = self.shapes[key]
            so, d1, d2 = self.fr.sub_offset(qRf, qp, g.sub(self.target, qr2))
            mat = b.reshape(b.shape[0], -1)   # (dl, dp*dr2)
            x_view = x[off:off + dl * dr].reshape(dl, dr)
            x_view[:, so:so + d1 * d2] = mat
        return x

    def vec_to_tensor(self, x: np.ndarray):
        from .mps import MPSTensor
        g = self.g
        blocks = {}
        for key in self.keys:
            qb, qRf = key
            off = self.offsets[key]
            dl, dr = self.shapes[key]
            mat = x[off:off + dl * dr].reshape(dl, dr)
            for (qp, qc2, so, d1, d2) in self.fr.maps[qRf]:
                qr2 = g.sub(self.target, qc2)
                blocks[(qb, qp, qr2)] = \
                    mat[:, so:so + d1 * d2].reshape(dl, d1, d2)
        return MPSTensor(g, blocks)

    def matvec_np(self, x: np.ndarray) -> np.ndarray:
        psi = {}
        for k in self.keys:
            dl, dr = self.shapes[k]
            off = self.offsets[k]
            psi[k] = x[off:off + dl * dr].reshape(dl, dr)
        dt = np.result_type(self.dtype, x.dtype)
        out = np.zeros(self.size, dtype=dt)
        for (m, lk, pk, rk, ok) in self.triples:
            contrib = self.LW[m][lk] @ psi[pk] @ self.RW[m][rk].T
            off = self.offsets[ok]
            out[off:off + contrib.size] += contrib.ravel()
        return out

    def diagonal(self) -> np.ndarray:
        diag = np.zeros(self.size)
        for m, lw in self.LW.items():
            rw = self.RW.get(m)
            if rw is None:
                continue
            for (qb, qRf) in self.keys:
                lb = lw.get((qb, qb))
                rb = rw.get((qRf, qRf))
                if lb is not None and rb is not None:
                    off = self.offsets[(qb, qRf)]
                    dl, dr = self.shapes[(qb, qRf)]
                    d2 = (np.diag(lb)[:, None] * np.diag(rb)[None, :]).real
                    diag[off:off + dl * dr] += d2.ravel()
        return diag
