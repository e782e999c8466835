"""DMRGDriver of the port: the user-facing API.

Copied from block2_preview_tpu/driver/core.py (reference
pyblock2/driver/core.py:544: initialize_system at :854, get_qc_mpo at :3282
with FastBipartite, get_mpo at :3885, dmrg at :4437, get_random_mps at
:7494) and cut to what SZ two-site ground and excited states need.  The other
methods of the reference driver come back with their slices (ROADMAP);
``td_dmrg`` (time evolution, reference :4785) is here, and so are the
analysis of a solved state: ``expectation`` (:6840), ``get_npdm`` (:5504)
with its fronts ``get_1pdm`` ... ``get_6pdm``, ``get_trans_*pdm`` and
``get_conventional_*``, and the orbital entropies (:5091).

    drv = DMRGDriver(symm_type=SymmetryTypes.SZ)
    drv.initialize_system(n_sites=8, n_elec=8, spin=0)
    mpo = drv.get_qc_mpo(h1e=h1e, g2e=g2e, ecore=ecore)
    ket = drv.get_random_mps(bond_dim=80)
    energy = drv.dmrg(mpo, ket, bond_dims=[80])      # on the CUDA card
    roots = drv.dmrg(mpo, drv.get_random_mps(bond_dim=80), bond_dims=[80],
                     backend="torch_device", n_roots=3)  # three energies
    first = drv.extract_root(0)                      # one root as an MPS
    e, te = drv.td_dmrg(mpo, ket, delta_t=0.05, n_steps=2, bond_dim=80)
    dm1, dm2 = drv.get_1pdm(ket), drv.get_2pdm(ket)   # host engine
    dm3 = drv.get_3pdm(ket, algo="poly")    # class closes on the card (K17)

``dmrg``, ``td_dmrg`` and the polynomial PDM engine run on the card
unless the caller asks for the CPU (``device="cpu"``) or for the host
reference (``backend="numpy"``; ``device=None`` for the PDM closes).
"""

from __future__ import annotations

import enum
from typing import Optional, Sequence

import numpy as np

from ..core.expr import TermTable, qc_term_table
from ..core.fcidump import FCIDUMP
from ..core.symmetry import SZ_GROUP, SymmetryGroup
from ..dmrg.mpo import MPO
from ..dmrg.mpo_builder import build_mpo
from ..dmrg.mps import MPS, MPSInfo
from ..dmrg.sweep import DMRG
from ..ops.local_ops import SZ_SITE

__all__ = ["DMRGDriver", "SymmetryTypes"]


class SymmetryTypes(enum.Enum):
    """Mirrors reference pyblock2/driver/core.py:25 (the port runs SZ)."""
    SZ = "sz"


class DMRGDriver:
    def __init__(self, symm_type: SymmetryTypes = SymmetryTypes.SZ):
        if symm_type != SymmetryTypes.SZ:
            raise NotImplementedError("the port runs SZ symmetry only")
        self.symm_type = symm_type
        self.group: SymmetryGroup = SZ_GROUP
        self.spec = SZ_SITE
        self.n_sites = 0
        self.n_elec = 0
        self.spin = 0
        self.pg_irrep = 0
        self.orb_sym: Optional[np.ndarray] = None

    def initialize_system(self, n_sites: int, n_elec: int = 0, spin: int = 0,
                          orb_sym: Optional[Sequence[int]] = None,
                          pg_irrep: int = 0) -> None:
        """reference pyblock2/driver/core.py:854."""
        self.n_sites = n_sites
        self.n_elec = n_elec
        self.spin = spin
        self.pg_irrep = pg_irrep
        self.orb_sym = (np.zeros(n_sites, dtype=np.int64)
                        if orb_sym is None else np.asarray(orb_sym))

    @property
    def target(self):
        return (self.n_elec, self.spin, self.pg_irrep)

    # ------------------------------------------------------------------
    def read_fcidump(self, filename: str) -> FCIDUMP:
        fd = FCIDUMP.parse(filename)
        self.initialize_system(fd.n_sites, fd.n_elec, fd.twos,
                               orb_sym=fd.orb_sym, pg_irrep=fd.ipg)
        return fd

    def get_qc_mpo(self, h1e=None, g2e=None, ecore: float = 0.0,
                   fcidump: Optional[FCIDUMP] = None,
                   cutoff: float = 1e-13) -> MPO:
        """Quantum-chemistry MPO, bipartite construction (reference
        pyblock2/driver/core.py:3282, the FastBipartite analog)."""
        if fcidump is None:
            assert h1e is not None and g2e is not None
            fcidump = FCIDUMP(n_sites=self.n_sites, n_elec=self.n_elec,
                              twos=self.spin, ipg=self.pg_irrep,
                              orb_sym=self.orb_sym, const_e=ecore,
                              h1e=np.asarray(h1e), g2e=np.asarray(g2e))
        tt = qc_term_table(fcidump, group=self.group, cutoff=cutoff)
        return build_mpo(tt, site_pgs=fcidump.orb_sym,
                         const_e=fcidump.const_e, spec=self.spec)

    def get_mpo(self, term_table: TermTable, const_e: float = 0.0) -> MPO:
        """MPO from a term table, bipartite construction (reference
        pyblock2/driver/core.py:3885)."""
        return build_mpo(term_table, site_pgs=self.orb_sym, const_e=const_e)

    def get_random_mps(self, bond_dim: int = 250, target=None,
                       seed: int = 1234) -> MPS:
        """reference pyblock2/driver/core.py:7494."""
        site_quanta = [self.spec.quanta(int(p)) for p in self.orb_sym]
        info = MPSInfo(self.group, site_quanta, target or self.target,
                       bond_dim)
        return MPS.random(info, seed=seed)

    def dmrg(self, mpo: MPO, ket: MPS, bond_dims: Sequence[int] = (250,),
             noises: Sequence[float] = (1e-4, 1e-5, 0.0),
             thrds: Sequence[float] = (1e-10,), n_sweeps: int = 16,
             tol: float = 1e-9, iprint: int = 1, device="cuda",
             backend: str = "torch_resident", dtype=np.float64,
             n_roots: int = 1,
             proj_mpss: Optional[Sequence[MPS]] = None,
             proj_weights: Optional[Sequence[float]] = None,
             **kw):
        """Ground-state, state-averaged (``n_roots``) or state-specific
        (``proj_mpss``: project previously converged states out, or with
        ``proj_weights`` penalize them) SZ DMRG (reference
        pyblock2/driver/core.py:4437).  Returns the energy (a float) with
        one root, else every root's energy (an array).  On ``device``
        ("cuda" by default; it raises where there is no CUDA, with no
        fallback), one backend of five:

        * "torch_resident": every two-site step on the device (K1-K6); one
          root, no projection;
        * "torch": host environments and LW/RW, the sigma matvec of every
          site on the bucketed engine (kernel K8);
        * "torch_device": as "torch", and every environment blocking on
          the device (kernel K9); one float32 root solves entirely on the
          device;
        * "torch_stacked": environment pools on the device, blocked by the
          bucket engine (kernels K10 + K11), host LW/RW, the matvec on K8;
        * "torch_tiled": host LW/RW, the matvec on the tiled engine
          (kernel K7); real environments as device pools (K5 + K3), complex
          ones as host maps — it alone carries complex states.

        ``torch_resident`` and ``torch_tiled`` block their pools with the
        engine that ``B2TPU_STK_ENGINE`` names: "tiled" (default, K5 + K3),
        "tiled_v1" (K12) or "bucket" (K10 + K11).  ``torch_resident``
        honours ``B2TPU_MIX`` as the reference's jax_resident does: 4
        (default) mixes LW/RW on mix v4 (K3 + K4), 3 on mix v3 (K13 +
        K14), 2 on the v2 scatter mix (K15).  backend="numpy" is the
        host reference.  The solver is kept as
        ``self._last_dmrg`` (energies, timings, sweep_log,
        host_redo_count and the host transfer counters)."""
        solver = DMRG(mpo, ket, device=device, backend=backend,
                      dtype=dtype, iprint=iprint, n_roots=n_roots,
                      proj_mpss=proj_mpss, proj_weights=proj_weights, **kw)
        e = solver.solve(list(bond_dims), list(noises), list(thrds),
                         n_sweeps=n_sweeps, tol=tol)
        self._last_dmrg = solver
        return e

    def extract_root(self, r: int) -> MPS:
        """Single-root MPS from the last state-averaged solve (reference
        MultiMPS::extract + make_single, state_averaged.hpp:157; used by
        the statespecific workflow, block2main:2260)."""
        import copy
        s = self._last_dmrg
        m = copy.copy(s.mps)
        m.tensors = list(s.mps.tensors)
        if s._center_tensors is not None and \
                0 <= r < len(s._center_tensors):
            m.tensors[s._center_pos] = s._center_tensors[r]
        return m

    def get_dmrg_results(self):
        """(per-sweep energies, per-sweep discarded weights) of the last
        solve (reference pyblock2/driver/core.py:4988)."""
        s = self._last_dmrg
        return s.energies, s.discarded_weights

    def td_dmrg(self, mpo: MPO, ket: MPS, delta_t: float, n_steps: int,
                bond_dim: int, imaginary: bool = False, normalize=None,
                iprint: int = 0, device="cuda",
                backend: str = "torch_tiled"):
        """Two-site TDVP time evolution of ``ket`` (in place; reference
        pyblock2/driver/core.py:4785): real time in complex128, or
        imaginary time in f64 with ``imaginary=True``.  Every Krylov
        matvec runs on the tiled engine on ``device`` ("cuda" by default,
        no fallback); backend="numpy" is the host reference.  Returns (the
        final energy, the TimeEvolution with energies, norms, timings and
        counters)."""
        from ..dmrg.tdvp import TimeEvolution
        te = TimeEvolution(mpo, ket, imaginary=imaginary,
                           normalize=normalize, iprint=iprint,
                           backend=backend, device=device)
        e = te.solve(n_steps, delta_t, bond_dim)
        return e, te

    # -- analysis of a solved state (reference pyblock2/driver/core.py) ---

    def expectation(self, bra: MPS, mpo: MPO, ket: MPS) -> float:
        """<bra|MPO|ket> (reference pyblock2/driver/core.py:6840), by a
        full left contraction on the host environments."""
        from ..dmrg.expect import mpo_expectation
        return mpo_expectation(mpo, ket, bra=bra)

    def get_orbital_entropies(self, ket: MPS, ij_symm: int = 1):
        """One- or two-orbital von Neumann entropies
        (reference pyblock2/driver/core.py:5091, ij_symm as in get_npdm)."""
        from ..dmrg.expect import (orbital_entropy_1site,
                                   orbital_entropy_2site)
        if ij_symm == 1:
            return orbital_entropy_1site(ket)
        s2, _ = orbital_entropy_2site(ket)
        return s2

    def get_orbital_interaction_matrix(self, ket: MPS):
        """Mutual information I[i,j] = (S1[i] + S1[j] - S2[i,j]) / 2
        (reference pyblock2/driver/core.py get_orbital_interaction_matrix)."""
        from ..dmrg.expect import orbital_entropy_2site
        _, minfo = orbital_entropy_2site(ket)
        return minfo

    def get_npdm(self, ket: MPS, pdm_type: int = 1, bra: MPS = None,
                 algo: str = "auto", device="cuda"):
        """1-4+PDM; pass bra for transition densities (reference
        pyblock2/driver/core.py:5504 get_npdm / get_trans_1pdm), with the
        reference's routing: orders 1 and 2, and order 3 with algo
        'auto' or 'det', on the host string engine (dmrg/expect.py);
        orders >= 3 otherwise on the determinant engine (algo 'det', or
        'auto' on chains of at most 8 sites; dmrg/npdm.py) or the
        polynomial pooled-sweep engine (algo 'poly', dmrg/npdm_scheme.py),
        whose class closes run on ``device`` ("cuda" by default, kernel
        K17; "cpu" runs its twin; None keeps them on host BLAS).  SU(2)
        states are not carried by the port (roadmap item A6)."""
        from ..dmrg.expect import pdm1, pdm2_spatial, pdm3_spatial
        for m in (ket, bra):
            if m is not None and not isinstance(m, MPS):
                raise NotImplementedError(
                    f"get_npdm takes the port's SZ MPS (got {type(m)}); "
                    "spin-adapted (SU(2)) states are roadmap item A6")
        sym = self.orb_sym if bra is None else None
        if pdm_type == 1:
            return pdm1(ket, orb_sym=sym, bra=bra)
        elif pdm_type == 2:
            return pdm2_spatial(ket, orb_sym=sym,
                                assume_singlet=self.spin == 0 and bra is None,
                                bra=bra)
        elif pdm_type == 3 and algo in ("auto", "det"):
            return pdm3_spatial(ket, bra=bra)
        elif pdm_type >= 3:
            if algo == "det" or (algo == "auto" and ket.n_sites <= 8):
                from ..dmrg.npdm import npdm_spatial
                return npdm_spatial(ket, pdm_type, bra=bra)
            from ..dmrg.npdm_scheme import npdm_spatial_poly
            return npdm_spatial_poly(ket, pdm_type, bra=bra,
                                     device=device)
        raise NotImplementedError(f"pdm order {pdm_type}")

    def get_trans_1pdm(self, bra: MPS, ket: MPS):
        """Transition 1PDM <bra|c+ c|ket>
        (reference pyblock2/driver/core.py get_trans_1pdm)."""
        return self.get_npdm(ket, pdm_type=1, bra=bra)

    # fronts (reference core.py naming)

    def get_1pdm(self, ket, *, bra=None):
        """reference core.py get_1pdm."""
        return self.get_npdm(ket, pdm_type=1, bra=bra)

    def get_2pdm(self, ket, *, bra=None):
        return self.get_npdm(ket, pdm_type=2, bra=bra)

    def get_3pdm(self, ket, *, bra=None, algo: str = "auto", device="cuda"):
        return self.get_npdm(ket, pdm_type=3, bra=bra, algo=algo,
                             device=device)

    def get_4pdm(self, ket, *, bra=None, algo: str = "auto", device="cuda"):
        return self.get_npdm(ket, pdm_type=4, bra=bra, algo=algo,
                             device=device)

    def get_5pdm(self, ket, *, bra=None, device="cuda"):
        return self.get_npdm(ket, pdm_type=5, bra=bra, algo="poly",
                             device=device)

    def get_6pdm(self, ket, *, bra=None, device="cuda"):
        return self.get_npdm(ket, pdm_type=6, bra=bra, algo="poly",
                             device=device)

    def get_trans_2pdm(self, bra, ket):
        """Transition 2PDM (reference core.py get_trans_2pdm)."""
        return self.get_npdm(ket, pdm_type=2, bra=bra)

    def get_trans_3pdm(self, bra, ket, algo: str = "poly", device="cuda"):
        return self.get_npdm(ket, pdm_type=3, bra=bra, algo=algo,
                             device=device)

    def get_trans_4pdm(self, bra, ket, algo: str = "poly", device="cuda"):
        return self.get_npdm(ket, pdm_type=4, bra=bra, algo=algo,
                             device=device)

    def get_conventional_1pdm(self, ket, **kw):
        return self.get_1pdm(ket, **kw)

    def get_conventional_2pdm(self, ket, **kw):
        return self.get_2pdm(ket, **kw)

    def get_conventional_trans_1pdm(self, bra, ket):
        return self.get_trans_1pdm(bra, ket)

    def get_conventional_trans_2pdm(self, bra, ket):
        return self.get_trans_2pdm(bra, ket)

    def get_orbital_entropies_use_npdm(self, ket, ij_symm: int = 1):
        """reference core.py get_orbital_entropies_use_npdm — the same
        quantities through the correlator route."""
        return self.get_orbital_entropies(ket, ij_symm=ij_symm)
