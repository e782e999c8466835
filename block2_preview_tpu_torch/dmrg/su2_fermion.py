"""Spin-adapted (SU(2)) DMRG for fermions.

Extends the spin-chain engine (su2_spin.py) to fermionic sites: sectors are
(N, 2S, pg) triples, sites carry several multiplets (|0>, |singly-occ>, |2>),
the elementary operators are spin-1/2 tensor operators (creation/annihilation
spinors), and the coupled-product recoupling acquires a graded (fermionic)
phase.  This is the full non-abelian machinery of block2's SU2 universe
(reference src/core/clebsch_gordan.hpp SU2CG, src/dmrg/qc_hamiltonian.hpp SU2
site ops, src/core/sparse_matrix.hpp 9j recoupling).  The quantum-chemistry
MPO (complementary-operator term tables compiled by bipartite compression)
lives in su2_qc.py and runs on this engine.

Derived numerically and validated m-resolved (tests/test_su2_hubbard.py):
  * creation spinor C+ = (c_up^+, c_dn^+) is a rank-1/2 tensor; annihilation
    spinor C~ = (c_dn, -c_up); with |2> = c_up^+ c_dn^+ |0>, the nonzero
    reduced elements are
      <P||C+||V> = 1,  <D||C+||P> = -sqrt(2),
      <V||C~||P> = -sqrt(2),  <P||C~||D> = -1
    (V = vacuum (0,0), P = singly-occupied (1,1/2), D = doubly-occ (2,0))
  * graded coupled-product rule:
      <(a' b') j' || [A^{k1} (x) B^{k2}]^k || (a b) j>
        = (-1)^{p_B * N_a(ket)} * sqrt((2j+1)(2k+1)(2ja'+1)(2jb'+1))
          * 9j{ja jb j; k1 k2 k; ja' jb' j'} * <A> <B>
    where p_B is the fermion parity of operator B (the one that crosses
    subsystem a) and N_a the particle number of the ket state of a
  * hopping: sum_sigma c+_{1 sigma} c_{2 sigma} = -sqrt(2) [C+ (x) C~]^0
    and sum_sigma c+_{2 sigma} c_{1 sigma} = -sqrt(2) [C~ (x) C+]^0, so
    H_hop = sqrt(2) t ([C+ (x) C~]^0 + [C~ (x) C+]^0) for -t(c+c + h.c.)

Sectors q = (N, tj, pg); all spins DOUBLED; pg is an XOR point-group label.
Right-block labels use the complement convention (label = what remains for
the left), so the wavefunction sectors at a center are qL == qR, as in the
abelian engine.

Copied from block2_preview_tpu/dmrg/su2_fermion.py (the port keeps its own
copy) with the reference's two execution paths carried on the card:

* backend="torch_tiled" (the default, ``device="cuda"``): every
  environment blocking step runs on kernel K5's v2 path
  (``ops/su2blk.py``: the plan cached per (site, direction), the site
  values refreshed and the uploaded site pools dropped on every hit), and
  every centre's sigma matvec on kernel K7 (``ops/tiled.TiledExecutor``
  over ``_SU2EffAdapter``).  One root without projections solves in the
  port's device Davidson (``BucketExecutor.solve_ground_state``); several
  roots or projections use the host Davidson around K7's matvec.  On
  ``device="cpu"`` the same path runs the kernels' plain twins.
  The reference's TPU dispatch knobs are not carried: its
  ``exec_threshold`` (a host matvec below 4096 elements) and its
  ``B2TPU_SU2_BLK`` switch back to the interpreted blocking.
* backend="numpy": the host reference, the interpreted contractions and
  the host matvec.

Counters for the launch rules: ``n_matvec`` (every sigma product),
``host_matvec_count`` (those on the host), ``n_blocking`` (blocking steps
that launched K5), ``n_blocking_empty`` (steps whose plan was empty) and
``n_plan_builds`` (steps that built their plan rather than refreshing a
cached one);
``timings`` splits the time into plan building, the host round trip of
the pools, K5, LW/RW assembly, the solve and the decimation, and
``sweep_log`` keeps one such split a sweep.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.davidson import davidson
from .su2_spin import coupled_factor

BACKENDS = ("torch_tiled", "numpy")
# seconds kept in SU2FermionDMRG.timings: blocking steps in all ("blk"; on
# the device split into the host plan build, the pools' host round trip
# and K5), LW/RW assembly ("asm"), K7's executor set-up ("struct", "pack",
# "tables"), the eigensolver ("solve") and the decimation less its
# blocking step ("dm")
TIMING_KEYS = ("blk", "blk_plan", "blk_rt", "blk_k5", "asm", "struct",
               "pack", "tables", "solve", "dm")

SQ2 = np.sqrt(2.0)

# site multiplets: (N, 2S); reduced matrices are 3x3 over multiplet index
MULTS = [(0, 0), (1, 1), (2, 0)]


def _red(entries):
    m = np.zeros((3, 3))
    for (a, b), v in entries.items():
        m[a, b] = v
    return m


# (reduced matrix, rank k doubled, dN)
SITE_OPS = {
    "I": (_red({(0, 0): 1, (1, 1): 1, (2, 2): 1}), 0, 0),
    "C": (_red({(1, 0): 1.0, (2, 1): -SQ2}), 1, +1),
    "D": (_red({(0, 1): -SQ2, (1, 2): -1.0}), 1, -1),
    "N": (_red({(1, 1): 1.0, (2, 2): 2.0}), 0, 0),
    "NN": (_red({(2, 2): 1.0}), 0, 0),
}


def hubbard_su2_entries(t_hop: float, u: float):
    """4-symbol MPO for H = -t sum (c+ c + h.c.) + U sum n_up n_dn.
    Symbols: 0=I, 1=C+-pending, 2=C~-pending, 3=H."""
    return [(0, 0, "I", 1.0),
            (0, 1, "C", 1.0),
            (0, 2, "D", 1.0),
            (0, 3, "NN", u),
            (1, 3, "D", SQ2 * t_hop),
            (2, 3, "C", SQ2 * t_hop),
            (3, 3, "I", 1.0)], 4, {0: 0, 1: 1, 2: -1, 3: 0}


def _assemble(contribs, width, live) -> Dict[int, Dict]:
    """LW (or RW) blocks {m: {(Qb, Qk): block}} from the contributions
    (m, env block, rows), only the blocks ``live`` keeps, symbols and blocks
    in the reference's order (so the triples, and the host matvec's sums,
    come in its order too)."""
    ops: Dict[int, Dict] = {}
    for m, eb, rows in contribs:
        if not rows:
            continue
        dm = ops.setdefault(m, {})
        keep = live.get(m)
        if not keep:
            continue
        for (tgt, o1, d1, o2, d2, c) in rows:
            if tgt not in keep:
                continue
            blk = dm.get(tgt)
            if blk is None:
                blk = np.zeros((width[tgt[0]], width[tgt[1]]))
                dm[tgt] = blk
            blk[o1:o1 + d1, o2:o2 + d2] += c * eb
    return {m: d for m, d in ops.items() if d}


class _SU2EffAdapter:
    """Expose the SU(2) reduced-matrix sigma structure in the
    EffectiveHamiltonian interface consumed by ops.tiled.TiledExecutor:
    per-(m, Qb, Qk) scalar recoupling factors fold into the LW copies."""

    def __init__(self, keys, dims, offsets, size, LW, RW, ranks, dn):
        self.size = size
        self.offsets = offsets
        self.shapes = dims
        self.LW = {}
        self.RW = {}
        self.triples = []
        kset = set(keys)
        for m, lw in sorted(LW.items()):
            rw = RW.get(m)
            if rw is None:
                continue
            km = ranks[m]
            p_m = abs(dn[m]) % 2
            for (Qb, Qk), lb in sorted(lw.items()):
                if Qk not in kset or Qb not in kset:
                    continue
                rb = rw.get((Qb, Qk))
                if rb is None:
                    continue
                cross = coupled_factor(Qk[1], Qk[1], 0, km, km, 0,
                                       Qb[1], Qb[1], 0)
                if abs(cross) < 1e-14:
                    continue
                phase = -1.0 if (p_m and (Qk[0] & 1)) else 1.0
                key2 = (m, Qb, Qk)
                self.LW[key2] = {0: (phase * cross) * lb}
                self.RW[key2] = {0: rb}
                self.triples.append((key2, 0, Qk, 0, Qb))


class SU2OverlapEnvs:
    """Identity-overlap moving environments <mps|phi> between two
    reduced-tensor SU(2) MPS chains sharing the left-sequential coupling
    tree (the SU(2) analog of dmrg/projection.py OverlapEnvs; the
    identity transfer factor coupled_factor(j,jm,j',0,0,0,...) == 1, so
    transfers are plain contractions of the reduced blocks)."""

    def __init__(self, eng, phi_tensors: List[Dict], weight: float = 1.0):
        self.eng = eng
        self.phi = phi_tensors
        self.weight = float(weight)
        L = eng.L
        self.lo: List[Optional[Dict]] = [None] * (L + 1)
        self.ro: List[Optional[Dict]] = [None] * (L + 1)
        z = getattr(eng, "LV", (0, 0, 0))
        self.lo[0] = {z: np.ones((1, 1))}
        self.ro[L] = {eng.T: np.ones((1, 1))}
        self._lval = 0
        self._rval = L

    def _transfer_left(self, e: Dict, t: int) -> Dict:
        pby: Dict[Tuple, List] = {}
        for (ql, m, qr), b in self.phi[t].items():
            pby.setdefault((ql, m), []).append((qr, b))
        out: Dict[Tuple, np.ndarray] = {}
        for (ql, m, qr), a in self.eng.tensors[t].items():
            eb = e.get(ql)
            if eb is None:
                continue
            for qr2, pb in pby.get((ql, m), ()):
                if qr2 != qr:
                    continue
                c = a.T @ eb @ pb
                out[qr] = out.get(qr, 0) + c
        return out

    def _transfer_right(self, e: Dict, t: int) -> Dict:
        pby: Dict[Tuple, List] = {}
        for (ql, m, qr), b in self.phi[t].items():
            pby.setdefault((qr, m), []).append((ql, b))
        out: Dict[Tuple, np.ndarray] = {}
        for (ql, m, qr), a in self.eng.tensors[t].items():
            eb = e.get(qr)
            if eb is None:
                continue
            for ql2, pb in pby.get((qr, m), ()):
                if ql2 != ql:
                    continue
                c = a @ eb @ pb.T
                out[ql] = out.get(ql, 0) + c
        return out

    def ensure_lo(self, t: int) -> Dict:
        while self._lval < t:
            self.lo[self._lval + 1] = self._transfer_left(
                self.lo[self._lval], self._lval)
            self._lval += 1
        return self.lo[t]

    def ensure_ro(self, b: int) -> Dict:
        while self._rval > b:
            self._rval -= 1
            self.ro[self._rval] = self._transfer_right(
                self.ro[self._rval + 1], self._rval)
        return self.ro[b]

    def dirty(self, t_lo: int, t_hi: int) -> None:
        self._lval = min(self._lval, t_lo)
        self._rval = max(self._rval, t_hi + 1)

    def two_dot_vector(self, t: int, fl: Dict, fr: Dict, keys, dims,
                       offsets, size) -> np.ndarray:
        """phi compressed into the engine's two-site fused space at
        (t, t+1)."""
        lo = self.ensure_lo(t)
        ro = self.ensure_ro(t + 2)
        x = np.zeros(size)
        rby: Dict[Tuple, List] = {}
        for (qm, m2, qr2), br in self.phi[t + 1].items():
            rby.setdefault(qm, []).append((m2, qr2, br))
        for (ql, m, Q), bl in self.phi[t].items():
            if Q not in offsets:
                continue
            lom = lo.get(ql)
            if lom is None:
                continue
            row = {(r[0], r[1]): (r[2], r[3]) for r in fl[Q]}
            if (ql, m) not in row:
                continue
            o1, d1 = row[(ql, m)]
            col = {(r[0], r[1]): (r[2], r[3]) for r in fr[Q]}
            for (m2, qr2, br) in rby.get(Q, ()):
                rom = ro.get(qr2)
                if rom is None or (m2, qr2) not in col:
                    continue
                o2, d2 = col[(m2, qr2)]
                mat = np.einsum("ab,be,ec,dc->ad", lom, bl, br, rom,
                                optimize=True)
                off = offsets[Q]
                dl, dr = dims[Q]
                blk = x[off:off + dl * dr].reshape(dl, dr)
                blk[o1:o1 + d1, o2:o2 + d2] += mat
                x[off:off + dl * dr] = blk.ravel()
        return x


class SU2FermionDMRG:
    """Two-site spin-adapted DMRG over fermionic SU(2) sites.

    entries: (i, o, opname, coeff) — one list used at every site, or a
    per-site list of lists; sym_dn: {symbol: dN of the pending operator};
    target = (n_elec, 2S) or (n_elec, 2S, pg).

    ops: extra on-site operator registry {name: (reduced 3x3, 2k, dN)}
    merged over SITE_OPS (su2_qc.py supplies coupled composites).
    ranks: explicit {symbol: doubled rank}; if omitted, ranks are
    propagated from the boundary symbols (only possible for MPOs whose
    pending symbols never combine two nonzero ranks).
    site_pgs: per-site XOR point-group labels (default all 0).
    backend: "torch_tiled" (K5 + K7 on ``device``, "cuda" by default;
    "cpu" runs their twins) or "numpy" (the host reference).
    """

    def __init__(self, L: int, entries, n_symbols: int, sym_dn,
                 target: Tuple = None, bond_dim: int = 100,
                 seed: int = 7, iprint: int = 0, ops: Dict = None,
                 ranks: Dict[int, int] = None,
                 site_pgs: Optional[Sequence[int]] = None,
                 backend: str = "torch_tiled", exec_dtype=np.float64,
                 n_roots: int = 1,
                 weights: Optional[Sequence[float]] = None,
                 proj_tensors: Optional[List[List[Dict]]] = None,
                 proj_weights: Optional[Sequence[float]] = None,
                 init_tensors: Optional[List[Dict]] = None,
                 site_mults: Optional[List[List[Tuple]]] = None,
                 site_ops: Optional[Dict[int, Dict]] = None,
                 pg_mod: int = 0,
                 left_vacuum: Optional[Tuple[int, int, int]] = None,
                 bond_nrange: Optional[Tuple[Sequence[int],
                                             Sequence[int]]] = None,
                 device="cuda"):
        if backend not in BACKENDS:
            raise ValueError(
                f"backend {backend!r}: the spin-adapted engine runs "
                f"{BACKENDS} (the SZ backends torch_resident, torch, "
                "torch_device and torch_stacked take SZ MPSs only)")
        self.backend = backend
        self.exec_dtype = exec_dtype
        if backend == "numpy":
            self.device = None
        else:
            from ..runtime import resolve_device
            self.device = resolve_device(device)
        self.n_matvec = 0
        self.host_matvec_count = 0
        self.n_blocking = 0
        self.n_blocking_empty = 0
        self.n_plan_builds = 0
        self.timings = {k: 0.0 for k in TIMING_KEYS}
        self.sweep_log: List[Dict] = []
        # pg_mod = N: mod-N momentum/Lz labels instead of XOR irreps
        self.pg_mod = int(pg_mod)
        self.n_roots = int(n_roots)
        self.weights = list(weights) if weights is not None \
            else [1.0 / self.n_roots] * self.n_roots
        # state-specific projection against external reduced-tensor MPSs
        # (reference sweep_algorithm.hpp:81 ext_mpss / :111
        # projection_weights; ortho mode when proj_weights is None)
        self._proj_spec = proj_tensors or []
        self._proj_weights = list(proj_weights) if proj_weights \
            else None
        if self._proj_weights is not None:
            assert len(self._proj_weights) == len(self._proj_spec)
        self.L = L
        # entries: either one list used at every site, or a per-site list
        # of lists (site-dependent coefficients, e.g. long-range t_ij)
        if entries and isinstance(entries[0], list):
            assert len(entries) == L
            self.site_entries = [list(e) for e in entries]
        else:
            self.site_entries = [list(entries)] * L
        self.n_sym = n_symbols
        self.dn = dict(sym_dn)
        if target is None:
            target = (L, 0, 0)
        elif len(target) == 2:
            target = (target[0], target[1], 0)
        self.T = tuple(target)
        # singlet embedding (reference core.py:7217-7457 + MPSInfo
        # left_vacuum, mps.hpp): a fictitious boundary multiplet
        # (typically (2S, 2S, 0)) coupled so the chain target can be a
        # singlet while the physical state carries spin 2S
        self.LV = (0, 0, 0) if left_vacuum is None else tuple(left_vacuum)
        self.D = bond_dim
        self.iprint = iprint
        self.ops = dict(SITE_OPS)
        if ops:
            self.ops.update(ops)

        def _op_at(t, w):
            d = self.site_ops.get(t)
            if d is not None and w in d:
                return d[w]
            return self.ops[w]

        self._op_at = _op_at
        self.site_pgs = [0] * L if site_pgs is None else [int(p)
                                                          for p in site_pgs]
        # per-site multiplet quanta (N, 2S, pg); site_mults overrides
        # (heterogeneous chains, e.g. the CSF big site)
        if site_mults is not None:
            self.mults = [list(ms) for ms in site_mults]
        else:
            # |2> carries pg+pg: 0 under XOR, 2k mod N under momentum
            self.mults = [[(0, 0, 0), (1, 1, self.site_pgs[t]),
                           (2, 0, self._pg_add(self.site_pgs[t],
                                               self.site_pgs[t]))]
                          for t in range(L)]
        # per-site operator-registry overrides (big sites carry their
        # own reduced matrices, including a site-local identity)
        self.site_ops = {int(t): dict(d)
                         for t, d in (site_ops or {}).items()}
        if ranks is not None:
            self.rank: Dict[int, int] = dict(ranks)
        else:
            # symbol spin ranks by propagation (as in su2_spin)
            self.rank = {0: 0, n_symbols - 1: 0}
            all_entries = [e for es in self.site_entries for e in es]
            changed = True
            while changed:
                changed = False
                for (i, o, w, _c) in all_entries:
                    k = self.ops[w][1]
                    if i in self.rank and o not in self.rank:
                        ki = self.rank[i]
                        self.rank[o] = k if ki == 0 else \
                            (ki if k == 0 else None)
                        if self.rank[o] is None:
                            raise ValueError("ambiguous symbol rank")
                        changed = True
        # cumulative-particle-number windows per bond (the SU(2) analog
        # of MRCIMPSInfo/NEVPTMPSInfo bond restrictions, reference
        # mps.hpp:1400/1494): n_min[t] <= N(bond t) <= n_max[t]
        self._nrange = None
        if bond_nrange is not None:
            self._nrange = (list(bond_nrange[0]), list(bond_nrange[1]))
            assert len(self._nrange[0]) == L + 1
        self.bonds = self._fci_bonds(L, bond_dim)
        rng = np.random.RandomState(seed)
        # tensor blocks keyed (ql, mult, qr)
        if init_tensors is not None:
            # warm start from extract_root tensors (statespecific)
            self.tensors = [dict(blk) for blk in init_tensors]
        else:
            self.tensors = []
            for t in range(L):
                blk: Dict[Tuple, np.ndarray] = {}
                for ql, dl in self.bonds[t].items():
                    for m, qr in self._fuse_l(ql, t):
                        dr = self.bonds[t + 1].get(qr, 0)
                        if dr:
                            blk[(ql, m, qr)] = rng.standard_normal((dl, dr))
                self.tensors.append(blk)
        self._canonicalize_right()
        self.lenvs: List[Optional[Dict]] = [None] * (L + 1)
        self.renvs: List[Optional[Dict]] = [None] * (L + 1)
        z = self.LV
        self.lenvs[0] = {0: {(z, z): np.ones((1, 1))}}
        self.renvs[L] = {n_symbols - 1: {(self.T, self.T): np.ones((1, 1))}}
        t0 = time.perf_counter()
        for t in range(L - 1, 1, -1):
            self.renvs[t] = self._right_contract(t)
        self.t_init = time.perf_counter() - t0
        self.energies: List[float] = []
        # sweeps must alternate direction (the gauge after a forward sweep
        # is left-canonical, so only a backward sweep can follow); solve()
        # resumes from the recorded direction
        self._forward_next = True
        self._proj = [SU2OverlapEnvs(self, pt) for pt in self._proj_spec]
        # (site, forward, psis per root, kept_v) of the last update —
        # consumed by extract_root for the statespecific workflow
        self._last_center = None

    # -- sector fusion -------------------------------------------------
    # pg labels compose by XOR (D2h subgroups) or, with pg_mod = N > 0,
    # by mod-N addition (K-point momentum / Lz: the SU2K/SU2LZ family,
    # reference symmetry.hpp:1313 SU2KLong, :1491 SU2LZ)
    def _pg_add(self, a: int, b: int) -> int:
        return (a + b) % self.pg_mod if self.pg_mod else a ^ b

    def _pg_sub(self, a: int, b: int) -> int:
        return (a - b) % self.pg_mod if self.pg_mod else a ^ b

    def _fuse_l(self, q, t: int):
        """(bond q (x) site mult m) -> [(m, q')] left fusion at site t.
        Memoized: fusion lists depend only on (site, bond label) and are
        requested ~1e5 times per sweep from the plan/contract loops."""
        cache = getattr(self, "_fuse_cache", None)
        if cache is None:
            cache = self._fuse_cache = {}
        key = (0, t, q)
        hit = cache.get(key)
        if hit is not None:
            return hit
        n, tj, pg = q
        out = []
        for m, (nm, tjm, pgm) in enumerate(self.mults[t]):
            for tj2 in range(abs(tj - tjm), tj + tjm + 1, 2):
                out.append((m, (n + nm, tj2, self._pg_add(pg, pgm))))
        cache[key] = out
        return out

    def _fuse_r(self, q, t: int):
        """(site m (x) right label q) -> [(m, q')]; labels are complements
        (remaining-for-left), so the site SUBTRACTS its N and pg."""
        cache = getattr(self, "_fuse_cache", None)
        if cache is None:
            cache = self._fuse_cache = {}
        key = (1, t, q)
        hit = cache.get(key)
        if hit is not None:
            return hit
        n, tj, pg = q
        out = []
        for m, (nm, tjm, pgm) in enumerate(self.mults[t]):
            for tj2 in range(abs(tj - tjm), tj + tjm + 1, 2):
                out.append((m, (n - nm, tj2, self._pg_sub(pg, pgm))))
        cache[key] = out
        return out

    def _fci_bonds(self, L, maxd):
        left = [{self.LV: 1}]
        for t in range(L):
            nxt: Dict[Tuple[int, int, int], int] = {}
            for q, c in left[t].items():
                for m, q2 in self._fuse_l(q, t):
                    nxt[q2] = nxt.get(q2, 0) + c
            left.append(nxt)
        # right labels are complements: label(t) = target - N(sites >= t),
        # i.e. what remains for the left, so the match at a bond is
        # left == right; absorbing site t into the right block SUBTRACTS it
        right: List[Optional[Dict]] = [None] * (L + 1)
        right[L] = {self.T: 1}
        for t in range(L - 1, -1, -1):
            nxt = {}
            for q, c in right[t + 1].items():
                for m, q2 in self._fuse_r(q, t):
                    if q2[0] >= 0:
                        nxt[q2] = nxt.get(q2, 0) + c
            right[t] = nxt
        bonds = []
        for t in range(L + 1):
            caps = {q: min(left[t][q], right[t][q])
                    for q in left[t] if q in right[t]}
            if self._nrange is not None:
                lo, hi = self._nrange[0][t], self._nrange[1][t]
                caps = {q: c for q, c in caps.items() if lo <= q[0] <= hi}
            tot = sum(caps.values())
            if tot > maxd:
                caps = {q: max(1, int(round(c * maxd / tot)))
                        for q, c in caps.items()}
            assert caps, f"empty bond {t}: target unreachable"
            bonds.append(caps)
        return bonds

    def _canonicalize_right(self):
        for t in range(self.L - 1, 0, -1):
            blk = self.tensors[t]
            by_ql: Dict[Tuple, List] = {}
            for (ql, m, qr), b in blk.items():
                by_ql.setdefault(ql, []).append((m, qr, b))
            lmats = {}
            for ql, items in by_ql.items():
                items.sort(key=lambda x: (x[0], x[1]))
                mcat = np.concatenate([b for _, _, b in items], axis=1)
                q, r = np.linalg.qr(mcat.T)
                qt = q.T
                off = 0
                for (m, qr, b) in items:
                    blk[(ql, m, qr)] = qt[:, off:off + b.shape[1]]
                    off += b.shape[1]
                lmats[ql] = r.T
            prev = self.tensors[t - 1]
            for (ql, m, qr), b in list(prev.items()):
                if qr in lmats:
                    prev[(ql, m, qr)] = b @ lmats[qr]
                else:
                    del prev[(ql, m, qr)]

    # -- env recursions ------------------------------------------------
    # Like _eff_plan, the blocking enumeration (multiplet pairs x 9j
    # factors) depends only on the tensor block STRUCTURE at a site, so
    # it is cached per (t, direction, structure signature) with lazily
    # extended per-(entry, env-key) rows (reference ConnectionInfo
    # precompute, sparse_matrix.hpp:71).
    def _env_plan(self, t: int, direction: str, struct_sig):
        cache = getattr(self, "_env_plans", None)
        if cache is None:
            cache = self._env_plans = {}
        key = (t, direction, struct_sig)
        plan = cache.get(key)
        if plan is None:
            plan = {}
            cache[key] = plan
        return plan

    def _contract_su2_dev(self, t: int, direction: str,
                          env: Dict) -> Optional[Dict]:
        """Vectorized env contraction on kernel K5's v2 path
        (ops/su2blk.py) — replaces the interpreted quadruple loop below
        on the device backend, at every step.  Plans cache per (site,
        direction, structure); site-tensor VALUES refresh on every hit
        (they change each sweep), which also drops the plan's uploaded
        site pools.  The pools make a host round trip a step, as in the
        reference (:547-556): the environment is packed and uploaded, the
        output pool read back into a host dict."""
        if self.device is None:
            return None
        from ..ops.su2blk import build_su2_blocking, refresh_su2_sites, \
            run_su2_blocking
        t0 = time.perf_counter()
        cache = getattr(self, "_blk_cache", None)
        if cache is None:
            cache = self._blk_cache = {}
        A = self.tensors[t]
        sig = (tuple(sorted((k, b.shape) for k, b in A.items())),
               tuple(sorted((s, k, b.shape) for s, d in env.items()
                            for k, b in d.items())))
        key = (t, direction)
        ent = cache.get(key)
        if ent is not None and ent[0] == hash(sig):
            plan, in_meta, out_meta = ent[1]
            refresh_su2_sites(plan, A)
        else:
            res = build_su2_blocking(self, t, direction, env)
            if res is None:
                self.n_blocking_empty += 1
                self.timings["blk_plan"] += time.perf_counter() - t0
                return {}
            cache[key] = (hash(sig), res)
            self.n_plan_builds += 1
            plan, in_meta, out_meta = res
        self.timings["blk_plan"] += time.perf_counter() - t0
        new_env = run_su2_blocking(plan, in_meta, out_meta, env,
                                   dtype=self.exec_dtype, device=self.device,
                                   timings=self.timings)
        self.n_blocking += 1
        return new_env

    def _left_contract(self, t: int) -> Dict:
        """E'[o] on bond t+1 from [E[i] (x) w] rotated through A[t];
        graded phase (-1)^{p_w * N(ket bond)}"""
        env = self.lenvs[t]
        dev = self._contract_su2_dev(t, "left", env)
        if dev is not None:
            return dev
        A = self.tensors[t]
        mults = self.mults[t]
        by_ql: Dict[Tuple, List] = {}
        for (ql, m, qr), b in A.items():
            by_ql.setdefault(ql, []).append((m, qr, b))
        struct_sig = tuple(sorted((k, b.shape) for k, b in A.items()))
        plan = self._env_plan(t, "l", struct_sig)
        out: Dict[int, Dict] = {}
        for eidx, (i, o, w, cf) in enumerate(self.site_entries[t]):
            e = env.get(i)
            if e is None:
                continue
            for (qlb, qlk), eb in e.items():
                rows = plan.get((eidx, qlb, qlk))
                if rows is None:
                    rows = []
                    wred, k_w, dn_w = self._op_at(t, w)
                    p_w = abs(dn_w) % 2
                    k_i, k_o = self.rank[i], self.rank[o]
                    phase = -1.0 if (p_w and (qlk[0] & 1)) else 1.0
                    for (mb, qrb, _ab) in by_ql.get(qlb, ()):
                        for (mk, qrk, _ak) in by_ql.get(qlk, ()):
                            r = wred[mb, mk]
                            if r == 0.0:
                                continue
                            fac = coupled_factor(
                                qlk[1], mults[mk][1], qrk[1],
                                k_i, k_w, k_o,
                                qlb[1], mults[mb][1], qrb[1])
                            if abs(fac) < 1e-14:
                                continue
                            rows.append(((qlb, mb, qrb), (qlk, mk, qrk),
                                         (qrb, qrk), phase * fac * r * cf))
                    plan[(eidx, qlb, qlk)] = rows
                if not rows:
                    continue
                d = out.setdefault(o, {})
                for (kab, kak, okey, c) in rows:
                    contrib = c * (A[kab].T @ eb @ A[kak])
                    cur = d.get(okey)
                    d[okey] = contrib if cur is None else cur + contrib
        return out

    def _right_contract(self, t: int) -> Dict:
        """E'[i] on bond t from [w (x) E[o]] rotated through B[t];
        graded phase (-1)^{p_o * N(ket site multiplet)}"""
        env = self.renvs[t + 1]
        dev = self._contract_su2_dev(t, "right", env)
        if dev is not None:
            return dev
        B = self.tensors[t]
        mults = self.mults[t]
        by_qr: Dict[Tuple, List] = {}
        for (ql, m, qr), b in B.items():
            by_qr.setdefault(qr, []).append((m, ql, b))
        struct_sig = tuple(sorted((k, b.shape) for k, b in B.items()))
        plan = self._env_plan(t, "r", struct_sig)
        out: Dict[int, Dict] = {}
        for eidx, (i, o, w, cf) in enumerate(self.site_entries[t]):
            e = env.get(o)
            if e is None:
                continue
            for (qrb2, qrk2), eb in e.items():
                rows = plan.get((eidx, qrb2, qrk2))
                if rows is None:
                    rows = []
                    wred, k_w, dn_w = self._op_at(t, w)
                    p_o = abs(self.dn[o]) % 2
                    k_i, k_o = self.rank[i], self.rank[o]
                    for (mb, qlb, _bb) in by_qr.get(qrb2, ()):
                        for (mk, qlk, _bk) in by_qr.get(qrk2, ()):
                            r = wred[mb, mk]
                            if r == 0.0:
                                continue
                            phase = -1.0 if (p_o and (mults[mk][0] & 1)) \
                                else 1.0
                            fac = coupled_factor(
                                mults[mk][1], qrk2[1], qlk[1],
                                k_w, k_o, k_i,
                                mults[mb][1], qrb2[1], qlb[1])
                            if abs(fac) < 1e-14:
                                continue
                            rows.append(((qlb, mb, qrb2), (qlk, mk, qrk2),
                                         (qlb, qlk),
                                         phase * fac * r * cf))
                    plan[(eidx, qrb2, qrk2)] = rows
                if not rows:
                    continue
                d = out.setdefault(i, {})
                for (kbb, kbk, okey, c) in rows:
                    contrib = c * (B[kbb] @ eb @ B[kbk].T)
                    cur = d.get(okey)
                    d[okey] = contrib if cur is None else cur + contrib
        return out

    # -- effective Hamiltonian ------------------------------------------
    def bonds_actual(self, t: int, side: str = "left") -> Dict:
        if t == 0:
            return {self.LV: 1}
        if t == self.L:
            return {self.T: 1}
        dims: Dict[Tuple, int] = {}
        if side == "left":
            for (ql, m, qr), b in self.tensors[t - 1].items():
                dims[qr] = b.shape[1]
        else:
            for (ql, m, qr), b in self.tensors[t].items():
                dims[ql] = b.shape[0]
        return dims

    def _eff_plan(self, t: int, bond_l, bond_r):
        """Structural plan for the two-site effective Hamiltonian at t,
        cached by (t, bond signature): fused-sector layout plus lazily
        extended per-(entry, env-key) contribution rows.  The row lists
        depend only on the bond structure — only env block VALUES change
        across sweeps — so after the first visit a site update skips all
        fusion enumeration and Wigner-9j evaluation (the SU(2) analog of
        the abelian engine's ConnectionInfo precompute, reference
        sparse_matrix.hpp:71)."""
        sig = (t, tuple(sorted(bond_l.items())),
               tuple(sorted(bond_r.items())))
        cache = getattr(self, "_eff_plans", None)
        if cache is None:
            cache = self._eff_plans = {}
        plan = cache.get(sig)
        if plan is not None:
            return plan
        fl: Dict[Tuple, List[Tuple]] = {}   # Q -> [(ql, m, off, d)]
        for ql, d in sorted(bond_l.items()):
            for m, Q in self._fuse_l(ql, t):
                runs = fl.setdefault(Q, [])
                off = sum(r[3] for r in runs)
                runs.append((ql, m, off, d))
        fr: Dict[Tuple, List[Tuple]] = {}   # Q -> [(m, qr2, off, d)]
        for qr2, d in sorted(bond_r.items()):
            for m, Q in self._fuse_r(qr2, t + 1):
                runs = fr.setdefault(Q, [])
                off = sum(r[3] for r in runs)
                runs.append((m, qr2, off, d))
        keys = [Q for Q in sorted(fl) if Q in fr]
        if self._nrange is not None:
            # the fused two-dot sector label IS the interior (t+1) bond
            # quantum number, so the particle window applies directly
            lo, hi = self._nrange[0][t + 1], self._nrange[1][t + 1]
            keys = [Q for Q in keys if lo <= Q[0] <= hi]
        dims = {Q: (sum(r[3] for r in fl[Q]), sum(r[3] for r in fr[Q]))
                for Q in keys}
        offsets = {}
        off = 0
        for Q in keys:
            offsets[Q] = off
            off += dims[Q][0] * dims[Q][1]
        plan = {
            "fl": fl, "fr": fr, "keys": keys, "dims": dims,
            "offsets": offsets, "size": off,
            # (qlb, mb, Q) -> (off, d): the same (bond, multiplet) pair
            # fuses into SEVERAL total spins, so Q is part of the key
            "lmap": {(r[0], r[1], Q): (r[2], r[3])
                     for Q, runs in fl.items() for r in runs},
            "rmap": {(r[0], r[1], Q): (r[2], r[3])
                     for Q, runs in fr.items() for r in runs},
            "lw_rows": {}, "rw_rows": {}, "mv": None,
        }
        cache[sig] = plan
        return plan

    def _lw_rows_for(self, plan, t, eidx, entry, env_key):
        """Rows (tgt_key, o1, d1, o2, d2, coeff) for one (site-t entry,
        left-env block); computed once per plan and memoized."""
        rows = plan["lw_rows"].get((eidx, env_key))
        if rows is not None:
            return rows
        (i, o, w, cf) = entry
        qlb, qlk = env_key
        mults_t = self.mults[t]
        wred, k_w, dn_w = self._op_at(t, w)
        p_w = abs(dn_w) % 2
        k_i, k_m = self.rank[i], self.rank[o]
        phase = -1.0 if (p_w and (qlk[0] & 1)) else 1.0
        lmap = plan["lmap"]
        fl = plan["fl"]
        out = []
        for mb, Qb in self._fuse_l(qlb, t):
            hb = lmap.get((qlb, mb, Qb))
            if hb is None:
                continue
            for mk, Qk in self._fuse_l(qlk, t):
                hk = lmap.get((qlk, mk, Qk))
                if hk is None:
                    continue
                r = wred[mb, mk]
                if r == 0.0:
                    continue
                fac = coupled_factor(
                    qlk[1], mults_t[mk][1], Qk[1], k_i, k_w, k_m,
                    qlb[1], mults_t[mb][1], Qb[1])
                if abs(fac) < 1e-14:
                    continue
                out.append(((Qb, Qk), hb[0], hb[1], hk[0], hk[1],
                            phase * fac * r * cf))
        plan["lw_rows"][(eidx, env_key)] = out
        return out

    def _rw_rows_for(self, plan, t, eidx, entry, env_key):
        rows = plan["rw_rows"].get((eidx, env_key))
        if rows is not None:
            return rows
        (i, o, w, cf) = entry
        qr2b, qr2k = env_key
        mults_u = self.mults[t + 1]
        wred, k_w, dn_w = self._op_at(t + 1, w)
        p_o = abs(self.dn[o]) % 2
        k_m, k_o = self.rank[i], self.rank[o]
        rmap = plan["rmap"]
        fr = plan["fr"]
        out = []
        for mb, Qb in self._fuse_r(qr2b, t + 1):
            hb = rmap.get((mb, qr2b, Qb))
            if hb is None:
                continue
            for mk, Qk in self._fuse_r(qr2k, t + 1):
                hk = rmap.get((mk, qr2k, Qk))
                if hk is None:
                    continue
                r = wred[mb, mk]
                if r == 0.0:
                    continue
                phase = -1.0 if (p_o and (mults_u[mk][0] & 1)) else 1.0
                fac = coupled_factor(
                    mults_u[mk][1], qr2k[1], Qk[1], k_w, k_o, k_m,
                    mults_u[mb][1], qr2b[1], Qb[1])
                if abs(fac) < 1e-14:
                    continue
                out.append(((Qb, Qk), hb[0], hb[1], hk[0], hk[1],
                            phase * fac * r * cf))
        plan["rw_rows"][(eidx, env_key)] = out
        return out

    def _effective(self, t: int):
        env_l = self.lenvs[t]
        env_r = self.renvs[t + 2]
        bond_l = self.bonds_actual(t, "left")
        bond_r = self.bonds_actual(t + 2, "right")
        plan = self._eff_plan(t, bond_l, bond_r)
        fl, fr = plan["fl"], plan["fr"]
        keys, dims = plan["keys"], plan["dims"]
        offsets, size = plan["offsets"], plan["size"]
        fld = {Q: sum(x[3] for x in fl[Q]) for Q in fl}
        frd = {Q: sum(x[3] for x in fr[Q]) for Q in fr}

        # a block LW[m][(Qb, Qk)] enters a sigma triple only beside its
        # RW[m][(Qb, Qk)]: the blocks of one side alone are not assembled
        # (the reference builds them too; the sigma, diagonal and K7's
        # items are the same, the host work a fraction)
        lw_rows, rw_rows = [], []
        lw_keys: Dict[int, set] = {}
        rw_keys: Dict[int, set] = {}
        for eidx, entry in enumerate(self.site_entries[t]):
            e = env_l.get(entry[0])
            if e is None:
                continue
            ks = lw_keys.setdefault(entry[1], set())
            for env_key, eb in e.items():
                rows = self._lw_rows_for(plan, t, eidx, entry, env_key)
                ks.update(r[0] for r in rows)
                lw_rows.append((entry[1], eb, rows))
        for eidx, entry in enumerate(self.site_entries[t + 1]):
            e = env_r.get(entry[1])
            if e is None:
                continue
            ks = rw_keys.setdefault(entry[0], set())
            for env_key, eb in e.items():
                rows = self._rw_rows_for(plan, t, eidx, entry, env_key)
                ks.update(r[0] for r in rows)
                rw_rows.append((entry[0], eb, rows))
        live = {m: lw_keys[m] & rw_keys[m]
                for m in lw_keys.keys() & rw_keys.keys()}


        # LW[m][(Qb, Qk)] from [E_l[i] (x) w_t]
        LW = _assemble(lw_rows, fld, live)
        # RW[m][(Qb, Qk)] from [w_{t+1} (x) E_r[o]]
        RW = _assemble(rw_rows, frd, live)

        ranks = {m: self.rank[m] for m in set(LW) | set(RW)}

        # sigma triples with precomputed cross factors: the per-call
        # matvec is a flat loop of small GEMMs (reference
        # tensor_product_multiply semantics)
        triples = []
        for m, lw in LW.items():
            rw = RW.get(m)
            if rw is None:
                continue
            km = ranks[m]
            p_m = abs(self.dn[m]) % 2
            for (Qb, Qk), lb in lw.items():
                if Qk not in offsets or Qb not in offsets:
                    continue
                rb = rw.get((Qb, Qk))
                if rb is None:
                    continue
                cross = coupled_factor(Qk[1], Qk[1], 0, km, km, 0,
                                       Qb[1], Qb[1], 0)
                if abs(cross) < 1e-14:
                    continue
                phase = -1.0 if (p_m and (Qk[0] & 1)) else 1.0
                triples.append((Qb, Qk, phase * cross, lb, rb))

        # group triples by (Qb, Qk): within a group every lb shares one
        # shape and every rb another, so the whole group collapses into
        # TWO large GEMMs per matvec (the BatchGEMMSeq batching insight,
        # reference batch_gemm.hpp — stacked on the k and n axes instead
        # of looping B small GEMMs from Python).  Built at the first host
        # matvec: the device backend's solve never asks for them.
        gplans = []

        def host_gemms():
            groups = {}
            for (Qb, Qk, c, lb, rb) in triples:
                groups.setdefault((Qb, Qk), []).append((c, lb, rb))
            for (Qb, Qk), items in groups.items():
                a, k = items[0][1].shape
                p, n = items[0][2].shape
                B = len(items)
                L2 = np.concatenate([c * lb for (c, lb, _r) in items],
                                    axis=0)
                # Rf [p, B*n]: out[a,p] = sum_{b,n} T[a,b,n] R[p,b,n]
                Rf = np.stack([rb for (_c, _l, rb) in items], axis=1) \
                    .reshape(p, B * n)
                gplans.append((Qb, Qk, B, a, n, L2, Rf))

        def matvec(x):
            if not gplans:
                host_gemms()
            psi = {Q: x[offsets[Q]:offsets[Q] + dims[Q][0] * dims[Q][1]]
                   .reshape(dims[Q]) for Q in keys}
            sig = {Q: np.zeros(dims[Q]) for Q in keys}
            for (Qb, Qk, B, a, n, L2, Rf) in gplans:
                T = (L2 @ psi[Qk]).reshape(B, a, n)
                sig[Qb] += np.swapaxes(T, 0, 1).reshape(a, B * n) @ Rf.T
            out = np.zeros(size)
            for Q in keys:
                out[offsets[Q]:offsets[Q] + sig[Q].size] = sig[Q].ravel()
            return out

        diag = np.zeros(size)
        for (Qb, Qk, c, lb, rb) in triples:
            if Qb != Qk:
                continue
            o = offsets[Qb]
            diag[o:o + dims[Qb][0] * dims[Qb][1]] += \
                (c * np.diag(lb)[:, None] * np.diag(rb)[None, :]).ravel()
        self._last_ops = (LW, RW, ranks)
        return keys, dims, offsets, size, fl, fr, matvec, diag

    # -- sweeps ----------------------------------------------------------
    def sweep(self, forward: bool, dav_thrd: float = 1e-9,
              noise: float = 0.0) -> float:
        L = self.L
        emin = np.inf
        rng = range(L - 1) if forward else range(L - 2, -1, -1)
        if forward and L > 2 and self.renvs[2] is None:
            raise ValueError(
                "right environments are stale: sweeps must alternate "
                "directions (a forward sweep leaves the MPS left-canonical);"
                " use solve(), which resumes from the recorded direction")
        if not forward and L > 2 and self.lenvs[L - 2] is None:
            raise ValueError(
                "left environments are stale: sweeps must alternate "
                "directions; use solve()")
        self._forward_next = not forward
        emins = np.full(self.n_roots, np.inf)
        tm = self.timings
        before = dict(tm)
        nmv0, wall0 = self.n_matvec, time.perf_counter()
        for t in rng:
            t0 = time.perf_counter()
            keys, dims, offsets, size, fl, fr, matvec, diag = \
                self._effective(t)
            tm["asm"] += time.perf_counter() - t0
            x0 = self._guess(t, keys, dims, offsets, size, fl, fr)
            pvecs = [p.two_dot_vector(t, fl, fr, keys, dims, offsets,
                                      size) for p in self._proj] or None
            pv = dict(ortho=pvecs, proj_weights=self._proj_weights) \
                if pvecs else {}
            if self.n_roots > 1:
                rngr = np.random.RandomState(23 + t)
                x0 = np.concatenate(
                    [x0[:, None]] +
                    [rngr.standard_normal((size, 1))
                     for _ in range(self.n_roots - 1)], axis=1)
            t0 = time.perf_counter()
            if self.device is not None:
                w, v, nmv = self._device_solve(t, keys, dims, offsets,
                                               size, diag, x0, dav_thrd,
                                               pvecs, pv)
            else:
                def host_mv(x):
                    self.n_matvec += 1
                    self.host_matvec_count += 1
                    return matvec(x)
                w, v, nmv = davidson(host_mv, diag, x0,
                                     n_roots=self.n_roots,
                                     conv_thrd=dav_thrd,
                                     max_iter=400, max_subspace=40, **pv)
            tm["solve"] += time.perf_counter() - t0
            emins = np.minimum(emins, w[:self.n_roots])
            emin = min(emin, float(w[0]))
            psis = [{Q: v[offsets[Q]:offsets[Q] + dims[Q][0] * dims[Q][1],
                          r].reshape(dims[Q]) for Q in keys}
                    for r in range(self.n_roots)]
            psi = psis[0]
            rhos: Dict[Tuple, np.ndarray] = {}
            for r, p_r in enumerate(psis):
                wr = self.weights[r]
                for Q, p in p_r.items():
                    c = (wr / (Q[1] + 1.0)) * \
                        (p @ p.T if forward else p.T @ p)
                    rhos[Q] = rhos.get(Q, 0) + c
            if noise > 0.0:
                for Q in rhos:
                    rhos[Q] = rhos[Q] + noise * np.eye(rhos[Q].shape[0])
            t0, blk0 = time.perf_counter(), tm["blk"]
            self._decimate(t, rhos, fl if forward else fr, forward, psi)
            tm["dm"] += time.perf_counter() - t0 - (tm["blk"] - blk0)
            self._last_center = (t, forward, psis, self._kept_v)
            for p in self._proj:
                p.dirty(t, t + 1)
            if self.iprint >= 2:
                estr = " ".join(f"{x:.10f}" for x in w[:self.n_roots])
                print(f"  su2f {'-->' if forward else '<--'} site {t:3d} "
                      f"E = {estr} nmv={nmv}")
        self.energies.append(emins if self.n_roots > 1 else emin)
        self.sweep_log.append(dict(
            forward=forward, wall=time.perf_counter() - wall0,
            matvecs=self.n_matvec - nmv0,
            **{k: tm[k] - before[k] for k in TIMING_KEYS}))
        return emins if self.n_roots > 1 else emin

    def _device_solve(self, t, keys, dims, offsets, size, diag, x0,
                      dav_thrd, pvecs, pv):
        """(eigenvalues, vectors, matvecs) of the centre at t with every
        sigma product on kernel K7 (the reference's :940-975 without its
        host path below ``exec_threshold``): the port's device Davidson
        for one root without projections, the host Davidson around K7's
        matvec otherwise."""
        from ..ops.tiled import TiledExecutor
        LW, RW, ranks2 = self._last_ops
        ad = _SU2EffAdapter(keys, dims, offsets, size, LW, RW, ranks2,
                            self.dn)
        if not hasattr(self, "_tiled_cache"):
            self._tiled_cache = {}
        ex = TiledExecutor(ad, dtype=self.exec_dtype,
                           cache=self._tiled_cache, cache_key=t,
                           device=self.device)
        tm = self.timings
        tm["struct"] += ex.t_struct
        tm["pack"] += ex.t_pack
        tm["tables"] += ex.t_tables
        try:
            if self.n_roots == 1 and not pvecs:
                th, xv, nmv = ex.solve_ground_state(
                    x0, diag, conv_thrd=dav_thrd, max_iter=400,
                    max_subspace=40)
                self.n_matvec += nmv
                return np.array([th]), xv[:, None], nmv

            def dev_mv(x):
                self.n_matvec += 1
                return ex.matvec(x)
            return davidson(dev_mv, diag, x0 if x0.ndim == 2
                            else x0[:, None], n_roots=self.n_roots,
                            conv_thrd=dav_thrd, max_iter=400,
                            max_subspace=40, **pv)
        finally:
            ex.free()

    def _guess(self, t, keys, dims, offsets, size, fl, fr):
        x0 = np.random.RandomState(11 + t).standard_normal(size)
        return x0 / np.linalg.norm(x0)

    def _decimate(self, t, rhos, fused, forward, psi=None):
        eigs, vecs = [], {}
        for Q, r in rhos.items():
            ww, vv = np.linalg.eigh(r)
            vecs[Q] = vv
            eigs += [(float(x), Q, i) for i, x in enumerate(ww)]
        eigs.sort(key=lambda z: -z[0])
        kept: Dict[Tuple, List[int]] = {}
        budget = self.D
        nr = self._nrange
        for (x, Q, i) in eigs:
            if nr is not None and not \
                    (nr[0][t + 1] <= Q[0] <= nr[1][t + 1]):
                continue
            # keep states up to the multiplet budget even at (near-)zero
            # weight: at FCI-capped bonds this preserves exactness; dropping
            # zero-weight multiplets creates noise-free local minima
            # (block2 escapes those via perturbative noise,
            # reference src/dmrg/effective_hamiltonian.hpp:253)
            if budget <= 0 or x < 0.0:
                break
            kept.setdefault(Q, []).append(i)
            budget -= 1
        new_tensor: Dict[Tuple, np.ndarray] = {}
        kept_v: Dict[Tuple, np.ndarray] = {}
        self._kept_v = kept_v
        for Q, idxs in kept.items():
            vmat = vecs[Q][:, idxs]
            kept_v[Q] = vmat
            if forward:
                for (ql, m, off, d) in fused[Q]:
                    new_tensor[(ql, m, Q)] = vmat[off:off + d, :]
            else:
                for (m, qr2, off, d) in fused[Q]:
                    new_tensor[(Q, m, qr2)] = vmat[off:off + d, :].T
        if forward:
            self.tensors[t] = new_tensor
            # absorb the projected center into the neighbor tensor so the
            # stored MPS always IS the current state (block2 keeps this in
            # MPS::canonical_form / center wavefunctions, mps.hpp:1656)
            if psi is not None:
                nxt: Dict[Tuple, np.ndarray] = {}
                for Q, vmat in kept_v.items():
                    cen = vmat.T @ psi[Q]     # (kept, fr(Q))
                    for (m, qr2, off, d) in self._effective_fr(t, Q):
                        nxt[(Q, m, qr2)] = cen[:, off:off + d]
                self.tensors[t + 1] = nxt
            t0 = time.perf_counter()
            self.lenvs[t + 1] = self._left_contract(t)
            self.timings["blk"] += time.perf_counter() - t0
            for u in range(t + 2, self.L + 1):
                self.lenvs[u] = None
            for u in range(t + 1, -1, -1):
                self.renvs[u] = None
        else:
            self.tensors[t + 1] = new_tensor
            if psi is not None:
                prv: Dict[Tuple, np.ndarray] = {}
                for Q, vmat in kept_v.items():
                    cen = psi[Q] @ vmat       # (fl(Q), kept)
                    for (ql, m, off, d) in self._effective_fl(t, Q):
                        prv[(ql, m, Q)] = cen[off:off + d, :]
                self.tensors[t] = prv
            t0 = time.perf_counter()
            self.renvs[t + 1] = self._right_contract(t + 1)
            self.timings["blk"] += time.perf_counter() - t0
            for u in range(t, -1, -1):
                self.renvs[u] = None
            for u in range(t + 1, self.L + 1):
                self.lenvs[u] = None
            z = self.LV
            self.lenvs[0] = {0: {(z, z): np.ones((1, 1))}}

    # fused-run layouts reused by the center-absorption step
    def _effective_fl(self, t, Q=None):
        bond_l = self.bonds_actual(t, "left")
        fl: Dict[Tuple, List[Tuple]] = {}
        for ql, d in sorted(bond_l.items()):
            for m, Q2 in self._fuse_l(ql, t):
                runs = fl.setdefault(Q2, [])
                off = sum(r[3] for r in runs)
                runs.append((ql, m, off, d))
        return fl if Q is None else fl.get(Q, [])

    def _effective_fr(self, t, Q=None):
        bond_r = self.bonds_actual(t + 2, "right")
        fr: Dict[Tuple, List[Tuple]] = {}
        for qr2, d in sorted(bond_r.items()):
            for m, Q2 in self._fuse_r(qr2, t + 1):
                runs = fr.setdefault(Q2, [])
                off = sum(r[3] for r in runs)
                runs.append((m, qr2, off, d))
        return fr if Q is None else fr.get(Q, [])

    def solve(self, n_sweeps: int = 10, tol: float = 1e-9,
              noises: Optional[Sequence[float]] = None,
              dav_thrds: Optional[Sequence[float]] = None):
        last = np.full(self.n_roots, np.inf)
        for i in range(n_sweeps):
            noise = noises[min(i, len(noises) - 1)] if noises else 0.0
            thrd = dav_thrds[min(i, len(dav_thrds) - 1)] \
                if dav_thrds else 1e-9
            e = self.sweep(self._forward_next, dav_thrd=thrd, noise=noise)
            earr = np.atleast_1d(e)
            if self.iprint >= 1:
                estr = " ".join(f"{x:.12f}" for x in earr)
                print(f"su2f sweep {i}: E = {estr}")
            if np.max(np.abs(earr - last)) < tol and noise == 0.0:
                break
            last = earr
        return self.energies[-1]

    def extract_root(self, r: int) -> List[Dict]:
        """Copy of the MPS tensors with root r's center wavefunction
        absorbed (reference MultiMPS::extract + make_single,
        state_averaged.hpp:157)."""
        tensors = [dict(blk) for blk in self.tensors]
        if self._last_center is None or r == 0:
            return tensors
        t, forward, psis, kept_v = self._last_center
        psi = psis[r]
        if forward:
            nxt: Dict[Tuple, np.ndarray] = {}
            for Q, vmat in kept_v.items():
                if Q not in psi:
                    continue
                cen = vmat.T @ psi[Q]
                for (m, qr2, off, d) in self._effective_fr(t, Q):
                    nxt[(Q, m, qr2)] = cen[:, off:off + d]
            tensors[t + 1] = nxt
        else:
            prv: Dict[Tuple, np.ndarray] = {}
            for Q, vmat in kept_v.items():
                if Q not in psi:
                    continue
                cen = psi[Q] @ vmat
                for (ql, m, off, d) in self._effective_fl(t, Q):
                    prv[(ql, m, Q)] = cen[off:off + d, :]
            tensors[t] = prv
        return tensors


def hubbard_su2_dmrg(L: int, t_hop: float = 1.0, u: float = 2.0,
                     n_elec: Optional[int] = None, twos: int = 0,
                     bond_dim: int = 100, iprint: int = 0,
                     seed: int = 7, backend: str = "torch_tiled",
                     device="cuda") -> SU2FermionDMRG:
    entries, n_sym, dn = hubbard_su2_entries(t_hop, u)
    return SU2FermionDMRG(L, entries, n_sym, dn,
                          target=(n_elec if n_elec is not None else L, twos),
                          bond_dim=bond_dim, iprint=iprint, seed=seed,
                          backend=backend, device=device)


def su2_one_electron_entries(tmat: np.ndarray, u: float = 0.0,
                             eps: Optional[Sequence[float]] = None):
    """Per-site MPO entries for a general one-electron Hamiltonian plus a
    local Hubbard U,

        H = sum_{i<j} t_ij sum_sigma (c+_i c_j + h.c.)
            + sum_i eps_i n_i + U sum_i n_up n_dn,

    in spin-adapted form: each pending creation/annihilation spinor gets its
    own rank-1 symbol; pass-through entries are plain identities — the
    Jordan-Wigner strings live entirely in the graded recoupling phase.
    Returns (per-site entries, n_symbols, sym_dn)."""
    tmat = np.asarray(tmat)
    L = tmat.shape[0]
    c_sym = {i: 1 + i for i in range(L)}
    d_sym = {i: 1 + L + i for i in range(L)}
    H = 2 * L + 1
    dn = {0: 0, H: 0}
    for i in range(L):
        dn[c_sym[i]] = +1
        dn[d_sym[i]] = -1
    site_entries: List[List] = []
    for s in range(L):
        es: List = [(0, 0, "I", 1.0), (H, H, "I", 1.0)]
        if u != 0.0:
            es.append((0, H, "NN", u))
        if eps is not None and eps[s] != 0.0:
            es.append((0, H, "N", float(eps[s])))
        opens_c = any(abs(tmat[s, j]) > 0 for j in range(s + 1, L))
        if opens_c:
            es.append((0, c_sym[s], "C", 1.0))
            es.append((0, d_sym[s], "D", 1.0))
        for i in range(s):
            live = any(abs(tmat[i, j]) > 0 for j in range(s, L))
            if not live:
                continue
            if abs(tmat[i, s]) > 0:
                es.append((c_sym[i], H, "D", -SQ2 * tmat[i, s]))
                es.append((d_sym[i], H, "C", -SQ2 * tmat[i, s]))
            if any(abs(tmat[i, j]) > 0 for j in range(s + 1, L)):
                es.append((c_sym[i], c_sym[i], "I", 1.0))
                es.append((d_sym[i], d_sym[i], "I", 1.0))
        site_entries.append(es)
    return site_entries, 2 * L + 2, dn
