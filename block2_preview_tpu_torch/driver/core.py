"""DMRGDriver of the port: the user-facing API.

Copied from block2_preview_tpu/driver/core.py (reference
pyblock2/driver/core.py:544: initialize_system at :854, get_qc_mpo at :3282
with FastBipartite, get_mpo at :3885, dmrg at :4437, get_random_mps at
:7494) and cut to the SZ, SU2 and SAny modes.  The other methods of the reference
driver come back with their slices (ROADMAP); here are ``td_dmrg`` (time evolution,
reference :4785), the linear sweeps ``compress_mps`` (:6300),
``multiply`` (:6506) and ``addition`` (:6702), ``greens_function``
(:6923), ``orbital_rotation``, ``expr_builder`` (SZ operator strings,
:8975) with ``get_site_mpo`` and ``get_identity_mpo``, and the analysis
of a solved state: ``expectation`` (:6840), ``get_npdm`` (:5504) with its
fronts ``get_1pdm`` ... ``get_6pdm``, ``get_trans_*pdm`` and
``get_conventional_*``, and the orbital entropies (:5091).

    drv = DMRGDriver(symm_type=SymmetryTypes.SZ)
    drv.initialize_system(n_sites=8, n_elec=8, spin=0)
    mpo = drv.get_qc_mpo(h1e=h1e, g2e=g2e, ecore=ecore)
    ket = drv.get_random_mps(bond_dim=80)
    energy = drv.dmrg(mpo, ket, bond_dims=[80])      # on the CUDA card
    e1 = drv.dmrg(mpo, ket, bond_dims=[80], backend="torch_tiled",
                  twodot_to_onedot=4)               # one-site sweeps last
    roots = drv.dmrg(mpo, drv.get_random_mps(bond_dim=80), bond_dims=[80],
                     backend="torch_device", n_roots=3)  # three energies
    first = drv.extract_root(0)                      # one root as an MPS
    e, te = drv.td_dmrg(mpo, ket, delta_t=0.05, n_steps=2, bond_dim=80)
    g = drv.greens_function(mpo, ket, energy, "d", 0, -0.4, 0.05, 80)
    small, nrm = drv.compress_mps(ket, 40, mpo)      # host sweeps
    drv.orbital_rotation(ket, kappa, bond_dim=80)    # exp(kappa) in place
    dm1, dm2 = drv.get_1pdm(ket), drv.get_2pdm(ket)   # host engine
    dm3 = drv.get_3pdm(ket, algo="poly")    # class closes on the card (K17)

    su2 = DMRGDriver(symm_type=SymmetryTypes.SU2)    # spin-adapted
    su2.initialize_system(n_sites=8, n_elec=8, spin=2)  # 2S = 2
    mpo2 = su2.get_qc_mpo(h1e=h1e, g2e=g2e, ecore=ecore)
    ket2 = su2.get_random_mps(bond_dim=100)
    e2 = su2.dmrg(mpo2, ket2, bond_dims=[100])
    dm1 = su2.get_1pdm(ket2)                # through the SU2 -> SZ expansion

    tj = DMRGDriver(symm_type=SymmetryTypes.SZ)      # a t-J chain, SAnySU2
    tj.set_symmetry_groups("U1Fermi", "SU2", "SU2")
    tj.initialize_system(n_sites=L, target=(N, 0, 0), hamil_init=False)
    tj.get_custom_hamiltonian([[((0, 0, 0), 1), ((1, 1, 1), 1)]] * L,
                              [{"": np.eye(2), "C": C, "D": D}] * L)
    b = tj.expr_builder()
    b.add_term("(C+D)0", [0, 1, 1, 0], -2 ** 0.5)      # coupled strings
    e3 = tj.dmrg(tj.get_mpo(b.finalize()), tj.get_random_mps(bond_dim=250))

In the SU2 mode (the JAX package's driver/core.py:1210-1275) the MPO is an
``SU2MPO`` (the compiled spin-adapted entries, ``dmrg/su2_qc.py``), the
state an ``SU2MPSSpec`` that the engine materializes, and ``dmrg`` runs
``dmrg/su2_fermion.SU2FermionDMRG``: on the card by default
(``backend="torch_tiled"``: environment blocking on K5's v2 path, every
sigma product on K7), on the kernels' twins with ``device="cpu"``, or on
the host engine with ``backend="numpy"``.  The SZ-only backends raise
there.  ``get_npdm`` and its fronts take a solved ``SU2MPSSpec`` by
expanding it to SZ first (``trans_mps_to_sz``, ``utils/transform.py``).

``set_symmetry_groups`` composes the SAny mode (the JAX package's
driver/core.py:118-268): abelian factors give a ``SymmetryGroup``, and
``get_custom_hamiltonian`` per-site bases with numbered operator letters,
run on the SZ engines (``torch_resident`` by default, K1-K6); one
``"SU2", "SU2"`` pair (SAnySU2) gives multiplet bases with reduced
operator matrices, coupled expression strings compiled by
``dmrg/sany_su2.py``, and the spin-adapted engine (K5 and K7).  Still
raising, each naming its ROADMAP item: the SGF mode, CSF coefficients
(A6b.4) and SU(2) under a mesh (A6b.5); the SZ -> SGF transform is not
ported.

``dmrg``, ``td_dmrg``, ``greens_function``, ``orbital_rotation`` and the
polynomial PDM engine run on the card unless the caller asks for the CPU
(``device="cpu"``) or for the host reference (``backend="numpy"``;
``device=None`` for the PDM closes).  The linear sweeps run on the host,
as in the reference.
"""

from __future__ import annotations

import enum
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.expr import build_term_table, qc_term_table
from ..core.fcidump import FCIDUMP
from ..core.symmetry import SZ_GROUP, SymmetryGroup
from ..dmrg.mpo import MPO
from ..dmrg.mpo_builder import build_mpo
from ..dmrg.mps import MPS, MPSInfo
from ..dmrg.sweep import DMRG
from ..ops.local_ops import CRE_A, CRE_B, DES_A, DES_B, SZ_SITE

__all__ = ["DMRGDriver", "ExprBuilder", "SU2MPO", "SU2MPSSpec",
           "SymmetryTypes"]


class SymmetryTypes(enum.Enum):
    """Mirrors reference pyblock2/driver/core.py:25.  The port runs SZ, SU2
    and SAny (``set_symmetry_groups``); SGF is not ported yet and
    raises."""
    SZ = "sz"
    SGF = "sgf"
    SU2 = "su2"
    SAny = "sany"


# SZ-mode operator letters, matching pyblock2's ExprBuilder vocabulary
# (reference core.py:8975): c/d = alpha create/destroy, C/D = beta.
_OP_LETTERS = {"c": CRE_A, "d": DES_A, "C": CRE_B, "D": DES_B}


class ExprBuilder:
    """Collects operator strings for custom Hamiltonians (reference
    pyblock2/driver/core.py:8975; the JAX package's driver/core.py:42-93):
    SZ strings of c/d/C/D, strings of the letters a custom Hamiltonian
    defined (``get_custom_hamiltonian``), or, in the SAnySU2 mode, coupled
    expression strings such as "((C+D)2+(C+D)2)0"."""

    def __init__(self, driver: "DMRGDriver"):
        self.driver = driver
        self.terms: List[Tuple[float, List[Tuple[int, int]]]] = []
        self.su2_terms: List[Tuple[str, List[int], float]] = []
        self.const_e = 0.0

    def add_term(self, expr: str, idx: Sequence[int], coeff) -> "ExprBuilder":
        """expr like "cd" (one letter per operator), idx = site indices.
        In the SAnySU2 mode expr is a coupled expression string and idx
        may cover several repetitions of it (reference pyblock2
        ExprBuilder semantics)."""
        co = complex(coeff)
        co = co.real if co.imag == 0.0 else co
        if len(expr) == 0:
            self.const_e += co
            return self
        if self.driver._sany_su2_h is not None:
            self.su2_terms.append((expr, [int(i) for i in idx], co))
            return self
        if "(" in expr:
            raise ValueError(
                f"{expr!r}: coupled expression strings take the SAnySU2 "
                "mode (set_symmetry_groups with one \"SU2\", \"SU2\" "
                "pair, then get_custom_hamiltonian)")
        letters = self.driver._custom_letters or _OP_LETTERS
        bad = set(expr) - set(letters)
        if bad:
            raise ValueError(
                f"operator letters {sorted(bad)}: this Hamiltonian defines "
                f"{sorted(letters)}")
        if len(expr) != len(idx):
            raise ValueError(f"{expr!r} has {len(expr)} operators, got "
                             f"{len(idx)} site indices")
        ops = [(int(i), letters[ch]) for ch, i in zip(expr, idx)]
        self.terms.append((co, ops))
        return self

    def add_sum_term(self, expr: str, arr: np.ndarray,
                     cutoff: float = 1e-13) -> "ExprBuilder":
        """Add sum_{indices} arr[indices] * expr(indices)."""
        arr = np.asarray(arr)
        for idx in zip(*np.nonzero(np.abs(arr) > cutoff)):
            self.add_term(expr, [int(i) for i in idx], arr[idx])
        return self

    def finalize(self, adjust_order: bool = True):
        """adjust_order mirrors the reference flag; site ordering (with the
        SU(2) recoupling it implies) is always performed here.  Returns a
        TermTable, or in the SAnySU2 mode an SU2TermTable."""
        drv = self.driver
        if drv._sany_su2_h is not None:
            from ..dmrg.sany_su2 import compile_sany_su2_term_table
            return compile_sany_su2_term_table(drv._sany_su2_h,
                                               self.su2_terms,
                                               const_e=self.const_e)
        if drv._custom_specs is not None:
            return build_term_table(drv.n_sites, self.terms,
                                    group=drv.group, spec=drv._custom_specs)
        return build_term_table(drv.n_sites, self.terms, group=drv.group)


class DMRGDriver:
    def __init__(self, symm_type: SymmetryTypes = SymmetryTypes.SZ):
        if symm_type == SymmetryTypes.SGF:
            raise NotImplementedError(
                f"{symm_type}: the port runs the SZ, SU2 and SAny modes; "
                "the SGF mode is not ported yet (ROADMAP, 'Still missing "
                "inside ported modules')")
        self.symm_type = symm_type
        # the SU2 mode keeps the SZ group for the bookkeeping objects the
        # spin-adapted engine does not touch (FCIDUMP), as the reference;
        # the SAny mode replaces it in set_symmetry_groups
        self.group: SymmetryGroup = SZ_GROUP
        self.spec = SZ_SITE
        self.n_sites = 0
        self.n_elec = 0
        self.spin = 0
        self.pg_irrep = 0
        self.pg_mod = 0
        self.orb_sym: Optional[np.ndarray] = None
        # the SAny mode: the SU(2) slots of the composition, the custom
        # Hamiltonian (abelian specs and letters, or the SAnySU2 handle)
        # and the slot-tuple target
        self._sany_names: Tuple[str, ...] = ()
        self._sany_fermionic = False
        self._sany_su2: Optional[dict] = None
        self._sany_su2_h = None
        self._custom_specs = None
        self._custom_letters = None
        self._sany_target = None

    # -- the SAny mode (the JAX package's driver/core.py:118-268) ---------

    def set_symmetry_groups(self, *names: str, hints=None) -> None:
        """Runtime-composable symmetry (reference src/core/symmetry.hpp:58
        SAnyT and pyblock2 core.py:507 set_symmetry_groups): compose up to
        6 factors from "U1", "U1Fermi", "LZ", "AbelianPG", "Z<n>",
        "Z<n>Fermi".  The first *Fermi factor carries the fermion parity.

        Non-abelian SU(2) (the reference's SAnySU2 mode, e.g.
        ``set_symmetry_groups("U1Fermi", "SU2", "SU2")`` of the t-J /
        SU(2)-Hubbard custom-Hamiltonian tutorials) is taken as one
        consecutive "SU2", "SU2" pair (the doubled-spin slot appears
        twice, as in the reference quantum-number wrapper) plus at most
        one U1 / U1Fermi particle-number factor; such compositions are
        compiled onto the spin-adapted engine (dmrg/sany_su2.py).  Other
        compositions with SU2 raise NotImplementedError, as in the
        reference.  ``hints`` is accepted for the reference's signature."""
        if not 0 < len(names) <= 6:
            raise ValueError(f"1 to 6 symmetry factors, got {len(names)}")
        kinds: List[str] = []
        lows: List[str] = []
        fermi = None
        for i, nm in enumerate(names):
            if nm in ("U1", "LZ"):
                kinds.append("u1")
            elif nm == "U1Fermi":
                kinds.append("u1")
                fermi = i if fermi is None else fermi
            elif nm == "AbelianPG":
                kinds.append("xor")
            elif nm.startswith("Z") and nm.endswith("Fermi"):
                kinds.append(f"mod{int(nm[1:-5])}")
                fermi = i if fermi is None else fermi
            elif nm.startswith("Z"):
                kinds.append(f"mod{int(nm[1:])}")
            elif nm.startswith("SU2"):
                kinds.append("su2")
            else:
                raise ValueError(f"unknown symmetry group '{nm}'")
            lows.append(nm.lower())
        self.symm_type = SymmetryTypes.SAny
        self._sany_fermionic = fermi is not None
        self._sany_names = tuple(names)
        self._sany_su2 = None
        self._sany_su2_h = None
        self._custom_specs = None
        self._custom_letters = None
        if "su2" in kinds:
            su2_slots = tuple(i for i, k in enumerate(kinds) if k == "su2")
            if len(su2_slots) != 2 or su2_slots[1] != su2_slots[0] + 1:
                raise NotImplementedError(
                    "SU2 must appear as one consecutive pair of slots "
                    "(the reference SAnySU2 convention)")
            ab = [i for i, k in enumerate(kinds) if k != "su2"]
            if len(ab) > 1 or any(kinds[i] != "u1" for i in ab):
                raise NotImplementedError(
                    "SAnySU2 compositions support at most one U1/"
                    "U1Fermi particle-number factor beside the SU2 pair")
            self._sany_su2 = {"n_slot": ab[0] if ab else None,
                              "su2_slot": su2_slots[0]}
            return
        self.group = SymmetryGroup(tuple(kinds), tuple(lows),
                                   fermion_index=fermi or 0)

    def _get_sany_su2_hamiltonian(self, site_basis, site_ops,
                                  su2_ranks=None):
        """SAnySU2 custom Hamiltonian: reference-style multiplet bases
        (quanta tuples with a doubled-spin pair) and REDUCED operator
        matrices, compiled onto the spin-adapted engine (dmrg/sany_su2.py;
        reference custom-hamiltonians tutorial)."""
        from ..dmrg.sany_su2 import (SAnySU2Hamil, SiteSpaceSU2,
                                     infer_op_quanta)
        cfg = self._sany_su2
        ns, ss = cfg["n_slot"], cfg["su2_slot"]
        L = len(site_basis)
        self.n_sites = L
        site_mults, site_opdefs = [], []
        for t in range(L):
            mults = []
            for (q, cnt) in site_basis[t]:
                q = tuple(q)
                if q[ss] != q[ss + 1]:
                    raise ValueError(
                        f"site {t}: the SU2 slot pair must repeat 2S, got {q}")
                mults.extend([(int(q[ns]) if ns is not None else 0,
                               int(q[ss]), 0)] * int(cnt))
            site_mults.append(mults)
            space = SiteSpaceSU2(mults)
            n_of = [m[0] for m in mults]
            defs = {}
            for letter, mat in site_ops[t].items():
                if letter == "":
                    continue
                mat = np.asarray(mat, dtype=np.float64)
                nm = len(mults)
                if mat.shape != (nm, nm):
                    raise ValueError(
                        f"site {t} op '{letter}': expected a {nm}x{nm} "
                        f"REDUCED matrix over the multiplets, got "
                        f"{mat.shape}")
                k2, dn = infer_op_quanta(mat, space, n_of)
                if su2_ranks and letter in su2_ranks:
                    k2 = int(su2_ranks[letter])
                defs[letter] = (mat, k2, dn)
            site_opdefs.append(defs)
        self._sany_su2_h = SAnySU2Hamil(site_mults, site_opdefs)
        self._custom_specs = None
        return self

    def get_custom_hamiltonian(self, site_basis, site_ops,
                               orb_dependent_ops: str = "cdCD",
                               su2_ranks=None):
        """Custom site bases and elementary operators for the composed
        symmetry (reference pyblock2 core.py:2430 get_custom_hamiltonian /
        general_hamiltonian.hpp:1080): site_basis[t] is a list of
        (quantum-number tuple, multiplicity); site_ops[t] maps one-letter
        operator names to dense (dim, dim) matrices over that basis.
        Returns self (the driver doubles as the Hamiltonian handle) with
        expr_builder()/get_mpo()/get_random_mps wired to the custom sites.

        With an SU(2) pair in the composition (the SAnySU2 mode) the
        matrices are REDUCED multiplet-basis matrices, the terms coupled
        expression strings, and ``su2_ranks`` {letter: doubled rank}
        gives the rank of an operator its matrix leaves ambiguous (a bare
        spin operator).  ``orb_dependent_ops`` is accepted for the
        reference's signature."""
        if self._sany_su2 is not None:
            return self._get_sany_su2_hamiltonian(site_basis, site_ops,
                                                  su2_ranks=su2_ranks)
        from ..ops.local_ops import SiteBasisSpec
        if self.symm_type != SymmetryTypes.SAny:
            raise ValueError("call set_symmetry_groups first")
        L = len(site_basis)
        self.n_sites = L
        letters: Dict[str, int] = {}
        specs = []
        fermionic = self._sany_fermionic
        for t in range(L):
            quanta = [tuple(q) for (q, c) in site_basis[t]
                      for _ in range(int(c))]
            dim = len(quanta)
            par = np.diag([-1.0 if (fermionic and self.group.is_fermion(q))
                           else 1.0 for q in quanta])
            elem: Dict[int, np.ndarray] = {}
            for letter, mat in site_ops[t].items():
                code = letters.setdefault(letter, 100 + len(letters))
                mat = np.asarray(mat)
                if mat.shape != (dim, dim):
                    raise ValueError(
                        f"site {t} op '{letter}' shape {mat.shape} != {dim}")
                elem[code] = mat
            specs.append(SiteBasisSpec(
                f"sany{t}", dim, elem, np.eye(dim), par,
                (lambda q_: (lambda pg=0: list(q_)))(quanta),
                fermionic=fermionic))
        self._custom_specs = specs
        self._custom_letters = letters
        self.orb_sym = np.zeros(L, dtype=np.int64)
        return self

    def initialize_system(self, n_sites: int, n_elec: int = 0, spin: int = 0,
                          orb_sym: Optional[Sequence[int]] = None,
                          pg_irrep: int = 0, pg_mod: int = 0, vacuum=None,
                          target=None, hamil_init: bool = True) -> None:
        """reference pyblock2/driver/core.py:854.  ``pg_mod`` selects the
        orbital-label arithmetic of the SU(2) engine: 0 = XOR point group;
        N > 0 = mod-N addition, covering SU2K momentum labels
        (symmetry.hpp:1313) and, with N larger than any reachable total,
        SU2LZ additive Lz labels (symmetry.hpp:1491).

        ``vacuum``/``target``/``hamil_init`` mirror the reference's
        custom-Hamiltonian call style: a slot-tuple ``target`` is unpacked
        through the composed symmetry's slots (the SAny mode), or read as
        (N, 2S[, pg]); ``hamil_init=False`` defers the Hamiltonian to
        ``get_custom_hamiltonian``, which the port always does."""
        self._sany_target = None
        if target is not None and self._sany_su2 is not None:
            cfg = self._sany_su2
            n_elec = (int(target[cfg["n_slot"]])
                      if cfg["n_slot"] is not None else 0)
            spin = int(target[cfg["su2_slot"]])
        elif target is not None and self.symm_type == SymmetryTypes.SAny:
            self._sany_target = tuple(int(x) for x in target)
        elif target is not None:
            n_elec = int(target[0])
            spin = int(target[1]) if len(target) >= 2 else 0
            if len(target) >= 3:
                pg_irrep = int(target[2])
        self.n_sites = n_sites
        self.n_elec = n_elec
        self.spin = spin
        self.pg_irrep = pg_irrep
        self.pg_mod = int(pg_mod)
        self.orb_sym = (np.zeros(n_sites, dtype=np.int64)
                        if orb_sym is None else np.asarray(orb_sym))

    @property
    def target(self):
        """(N, 2S or 2Sz, pg); in the abelian SAny mode the slot tuple
        ``initialize_system(target=)`` gave."""
        if self._sany_target is not None:
            return self._sany_target
        return (self.n_elec, self.spin, self.pg_irrep)

    def _su2_engine_mode(self) -> bool:
        """True in the SU2 mode and the SAnySU2 mode: the states are
        SU2MPSSpecs on the spin-adapted engine."""
        return self.symm_type == SymmetryTypes.SU2 \
            or self._sany_su2 is not None

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
        if self.symm_type == SymmetryTypes.SAny:
            raise ValueError("the SAny mode takes its Hamiltonian from "
                             "get_custom_hamiltonian and expr_builder")
        if fcidump is None:
            assert h1e is not None and g2e is not None
            fcidump = FCIDUMP(n_sites=self.n_sites, n_elec=self.n_elec,
                              twos=self.spin, ipg=self.pg_irrep,
                              orb_sym=self.orb_sym, const_e=ecore,
                              h1e=np.asarray(h1e), g2e=np.asarray(g2e))
        if self.symm_type == SymmetryTypes.SU2:
            return _su2_qc_mpo(fcidump.h1e, fcidump.g2e, fcidump.const_e)
        tt = qc_term_table(fcidump, group=self.group, cutoff=cutoff)
        return build_mpo(tt, site_pgs=fcidump.orb_sym,
                         const_e=fcidump.const_e, spec=self.spec)

    def get_mpo(self, term_table, const_e: float = 0.0):
        """MPO from an ExprBuilder table, bipartite construction
        (reference pyblock2/driver/core.py:3885; the JAX package's
        driver/core.py:392-431): an SU2TermTable (the SAnySU2 mode) gives
        an ``SU2MPO`` carrying the custom sites' multiplets and identities
        (``site_mults``, ``site_ops``); a custom abelian Hamiltonian's
        table gives an MPO over its site bases; otherwise an SZ MPO (in
        the SU2 mode too, as the JAX package: an SZ operator for the SZ
        expansion of a spin-adapted state)."""
        from ..dmrg.su2_qc import SU2TermTable, compile_su2_entries
        if isinstance(term_table, SU2TermTable):
            ham = self._sany_su2_h
            if ham is None:
                raise ValueError(
                    "get_mpo received an SU2TermTable outside the SAnySU2 "
                    "mode (no custom Hamiltonian registered); the SU2 mode "
                    "builds its MPO with get_qc_mpo")
            mpo = SU2MPO(*compile_su2_entries(term_table))
            mpo.site_mults = ham.site_mults
            mpo.site_ops = {t: {"I": (np.eye(len(ham.site_mults[t])), 0, 0)}
                            for t in range(ham.L)}
            return mpo
        specs = self._custom_specs
        if specs is not None:
            return build_mpo(term_table, const_e=const_e, spec=specs,
                             site_quanta=[sp.quanta(0) for sp in specs])
        return build_mpo(term_table, site_pgs=self.orb_sym, const_e=const_e)

    def get_site_mpo(self, op: str, site: int) -> MPO:
        """SZ MPO of one elementary operator c/d/C/D at a site (reference
        pyblock2/driver/core.py:4029)."""
        if self.symm_type == SymmetryTypes.SAny:
            raise ValueError("in the SAny mode build a site operator with "
                             "expr_builder over the custom letters")
        tt = build_term_table(self.n_sites,
                              [(1.0, [(site, _OP_LETTERS[op])])],
                              group=self.group)
        return build_mpo(tt, site_pgs=self.orb_sym)

    def expr_builder(self) -> ExprBuilder:
        """reference pyblock2/driver/core.py:433."""
        return ExprBuilder(self)

    def get_random_mps(self, bond_dim: int = 250, target=None,
                       seed: int = 1234, init_tensors=None):
        """reference pyblock2/driver/core.py:7494.  In the SU2 mode an
        ``SU2MPSSpec`` (target (N, 2S, pg), multiplet bond dimension,
        seed; ``init_tensors`` a warm start from ``extract_root``); in
        the SAnySU2 mode too, a slot tuple such as (N, 2S, 2S) unpacked
        through the composition; in the abelian SAny mode an MPS over the
        custom site bases."""
        if self._su2_engine_mode():
            cfg = self._sany_su2
            tgt = self.target if target is None else tuple(target)
            if target is not None and cfg is not None \
                    and len(tgt) == len(self._sany_names):
                ss, ns = cfg["su2_slot"], cfg["n_slot"]
                tgt = (int(tgt[ns]) if ns is not None else 0,
                       int(tgt[ss]), 0)
            return SU2MPSSpec(tgt, bond_dim, seed=seed,
                              init_tensors=init_tensors)
        if init_tensors is not None:
            raise ValueError("init_tensors is an SU2-mode warm start")
        if self._custom_specs is not None:
            site_quanta = [sp.quanta(0) for sp in self._custom_specs]
        else:
            site_quanta = [self.spec.quanta(int(p)) for p in self.orb_sym]
        info = MPSInfo(self.group, site_quanta, target or self.target,
                       bond_dim)
        return MPS.random(info, seed=seed)

    def dmrg(self, mpo: MPO, ket: MPS, bond_dims: Sequence[int] = (250,),
             noises: Sequence[float] = (1e-4, 1e-5, 0.0),
             thrds: Sequence[float] = (1e-10,), n_sweeps: int = 16,
             tol: float = 1e-9, iprint: int = 1, device="cuda",
             backend: Optional[str] = None, dtype=np.float64,
             n_roots: int = 1,
             proj_mpss: Optional[Sequence[MPS]] = None,
             proj_weights: Optional[Sequence[float]] = None,
             twodot_to_onedot: Optional[int] = None, **kw):
        """Ground-state, state-averaged (``n_roots``) or state-specific
        (``proj_mpss``: project previously converged states out, or with
        ``proj_weights`` penalize them) SZ DMRG (reference
        pyblock2/driver/core.py:4437).  Returns the energy (a float) with
        one root, else every root's energy (an array).  On ``device``
        ("cuda" by default; it raises where there is no CUDA, with no
        fallback), one backend of five (``None``: "torch_resident"):

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
        host reference.  ``twodot_to_onedot`` = n switches to one-site
        sweeps from sweep n on (one root: K7 on "torch_tiled", K8 on the
        bucketed backends; "torch_resident" has no one-site engine and
        raises), and ``last_site_1site=True`` gives the last site of each
        two-site sweep a one-site update.  The solver is kept as
        ``self._last_dmrg`` (energies, timings, sweep_log,
        host_redo_count and the host transfer counters).

        In the SU2 and SAnySU2 modes ``mpo`` is an ``SU2MPO`` and ``ket``
        an ``SU2MPSSpec``, and the spin-adapted engine runs with bond
        dimension max(bond_dims) (multiplets), as the reference's
        ``_su2_dmrg``: backend "torch_tiled" (``None``; K5 + K7 on
        ``device``) or "numpy" (the host engine); the SZ backends,
        ``twodot_to_onedot`` and a mesh raise.  The engine is kept as
        ``self._last_dmrg`` and as ``ket.engine``.  The abelian SAny mode
        runs the SZ engines above on the custom site bases."""
        if self._su2_engine_mode():
            return _su2_dmrg(self, mpo, ket, bond_dims, noises, thrds,
                             n_sweeps, tol, iprint, n_roots=n_roots,
                             proj_mpss=proj_mpss, proj_weights=proj_weights,
                             backend=backend or "torch_tiled",
                             device=device, dtype=dtype,
                             twodot_to_onedot=twodot_to_onedot, **kw)
        backend = backend or "torch_resident"
        solver = DMRG(mpo, ket, device=device, backend=backend,
                      dtype=dtype, iprint=iprint, n_roots=n_roots,
                      proj_mpss=proj_mpss, proj_weights=proj_weights, **kw)
        e = solver.solve(list(bond_dims), list(noises), list(thrds),
                         n_sweeps=n_sweeps, tol=tol,
                         twodot_to_onedot=twodot_to_onedot)
        self._last_dmrg = solver
        return e

    def extract_root(self, r: int) -> MPS:
        """Single-root MPS from the last state-averaged solve (reference
        MultiMPS::extract + make_single, state_averaged.hpp:157; used by
        the statespecific workflow, block2main:2260).  In the SU2 mode an
        ``SU2MPSSpec`` warm-started from the engine's tensors with root
        r's centre absorbed (``SU2FermionDMRG.extract_root``)."""
        import copy
        s = self._last_dmrg
        if self._su2_engine_mode():
            lv = None if s.LV == (0, 0, 0) else s.LV
            return SU2MPSSpec(s.T, s.D, init_tensors=s.extract_root(r),
                              left_vacuum=lv)
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

    # -- linear sweeps, Green's functions, orbital rotation ---------------

    def get_identity_mpo(self, template: MPO) -> MPO:
        from ..dmrg.linear import identity_mpo
        return identity_mpo(template)

    def compress_mps(self, ket: MPS, bond_dim: int, template_mpo: MPO,
                     n_sweeps: int = 8, seed: int = 4321) -> Tuple[MPS, float]:
        """|x> ~ |ket> at smaller bond dimension, by host sweeps (reference
        pyblock2/driver/core.py:6300)."""
        from ..dmrg.linear import Linear, identity_mpo
        bra = self.get_random_mps(bond_dim, target=ket.info.target, seed=seed)
        lin = Linear(bra, [(identity_mpo(template_mpo), ket)])
        nrm = lin.solve(bond_dim, n_sweeps=n_sweeps)
        return bra, nrm

    def multiply(self, mpo: MPO, ket: MPS, bond_dim: int,
                 n_sweeps: int = 8, seed: int = 4321) -> Tuple[MPS, float]:
        """|x> ~ MPO|ket>, by host sweeps (reference
        pyblock2/driver/core.py:6506)."""
        from ..dmrg.linear import Linear
        bra = self.get_random_mps(bond_dim, target=ket.info.target, seed=seed)
        lin = Linear(bra, [(mpo, ket)])
        nrm = lin.solve(bond_dim, n_sweeps=n_sweeps)
        return bra, nrm

    def addition(self, a: MPS, b: MPS, template_mpo: MPO, bond_dim: int,
                 coeffs: Tuple[float, float] = (1.0, 1.0),
                 n_sweeps: int = 8, seed: int = 4321) -> Tuple[MPS, float]:
        """|x> ~ ca|a> + cb|b>, by host sweeps (reference
        pyblock2/driver/core.py:6702)."""
        from ..dmrg.linear import Linear, identity_mpo
        imp = identity_mpo(template_mpo)
        bra = self.get_random_mps(bond_dim, target=a.info.target, seed=seed)
        lin = Linear(bra, [(imp, a), (imp, b)], coeffs=list(coeffs))
        nrm = lin.solve(bond_dim, n_sweeps=n_sweeps)
        return bra, nrm

    def greens_function(self, h_mpo: MPO, gs: MPS, e0: float, op: str,
                        site: int, omega: float, eta: float, bond_dim: int,
                        n_sweeps: int = 6, iprint: int = 0,
                        squared: bool = False,
                        n_harmonic_projection: int = 0, device="cuda",
                        backend: str = "torch_tiled") -> complex:
        """G(omega) = <gs|op^dag (omega + E0 + i eta - H)^-1 op|gs>
        (reference pyblock2/driver/core.py:6923; gfdmrg.py:490).  The
        right-hand side op|gs> is fitted by host sweeps (``Linear``); the
        correction-vector sweeps run every local matvec on the tiled
        engine on ``device`` ("cuda" by default, no fallback; kernel K7,
        complex128), or on the host with backend="numpy".  squared=True:
        the real squared-operator solve (reference
        EquationTypes::GreensFunctionSquared, effective_functions.hpp:292)
        on K7 in float64, optionally with harmonic-Davidson deflation
        (``dmrg/greens.py`` takes float32 and the local solvers gcrotmk,
        idrs and lsqr).  The solver is kept as ``self._last_gf``
        (sweep_log, counters)."""
        from ..dmrg.greens import GreensFunction, GreensFunctionSquared
        from ..dmrg.linear import Linear
        smpo = self.get_site_mpo(op, site)
        dq = smpo.bond_dqs[-1][0]
        tb = self.group.add(gs.info.target, dq)
        b = self.get_random_mps(bond_dim, target=tb, seed=11)
        Linear(b, [(smpo, gs)]).solve(bond_dim, n_sweeps=n_sweeps)
        x = self.get_random_mps(bond_dim, target=tb, seed=13)
        if squared:
            gf = GreensFunctionSquared(
                h_mpo, b, x, iprint=iprint,
                n_harmonic_projection=n_harmonic_projection,
                backend=backend, device=device)
        else:
            gf = GreensFunction(h_mpo, b, x, iprint=iprint, backend=backend,
                                device=device)
        self._last_gf = gf
        return gf.solve(omega + e0, eta, bond_dim, n_sweeps=n_sweeps)

    def orbital_rotation(self, ket: MPS, kappa: np.ndarray,
                         bond_dim: int, n_steps: int = 10,
                         iprint: int = 0, device="cuda",
                         backend: str = "torch_tiled") -> MPS:
        """Rotate an MPS into a new orbital basis U = exp(kappa)
        (kappa real antisymmetric): |psi'> = exp(G)|psi> with the
        one-body generator G = sum_pq kappa_pq E_pq, applied as
        real-time TDVP under the Hermitian, complex MPO i*G for unit time
        (the JAX package's driver/core.py:563-588; reference
        unit_test/test_rotation_h10_sto6g.cpp semantics).  Every Krylov
        matvec runs on the tiled engine on ``device`` ("cuda" by default,
        no fallback; kernel K7, complex128), or on the host with
        backend="numpy".  Mutates and returns ``ket``; the time
        evolution is kept as ``self._last_te``."""
        from ..dmrg.tdvp import TimeEvolution
        kappa = np.asarray(kappa, dtype=np.float64)
        if not np.allclose(kappa, -kappa.T, atol=1e-12):
            raise ValueError("kappa must be antisymmetric")
        b = self.expr_builder()
        # i*G is Hermitian; exp(-i (iG) t)|t=1 = exp(G)
        b.add_sum_term("cd", 1j * kappa)
        b.add_sum_term("CD", 1j * kappa)
        gmpo = build_mpo(b.finalize(), site_pgs=self.orb_sym)
        te = TimeEvolution(gmpo, ket, imaginary=False, normalize=False,
                           iprint=iprint, backend=backend, device=device)
        self._last_te = te
        for _ in range(n_steps):
            te.sweep(True, 1.0 / n_steps, bond_dim)
            te.sweep(False, 1.0 / n_steps, bond_dim)
        return ket

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

    def trans_mps_to_sz(self, ket, tjz: int = None) -> MPS:
        """The exact SU2 -> SZ expansion of a solved spin-adapted state
        (reference pyblock2/driver/core.py:7217 mps_change_symm; the JAX
        package's driver/core.py:869-874), for its physical 2Sz = ``tjz``
        projection (the highest weight by default): ``utils/transform.py``.
        An engine whose last sweep ran backward first sweeps forward once,
        on its own backend (K5 and K7 on the card)."""
        from ..utils.transform import su2_to_sz_mps
        if not isinstance(ket, SU2MPSSpec) or ket.engine is None:
            raise ValueError("trans_mps_to_sz takes an SU2MPSSpec that "
                             "dmrg() has solved")
        return su2_to_sz_mps(ket.engine, tjz=tjz)

    def get_csf_coefficients(self, ket, cutoff: float = 0.05,
                             max_dets: int = 200):
        """Dominant configurations of a state (reference
        pyblock2/driver/core.py:6083): not ported yet."""
        raise NotImplementedError(
            "get_csf_coefficients: CSF coefficients of a spin-adapted state "
            "are roadmap item A6b.4 (dmrg/guga.py), determinant "
            "coefficients of an SZ state A14.2 (dmrg/determinant.py)")

    def get_npdm(self, ket: MPS, pdm_type: int = 1, bra: MPS = None,
                 algo: str = "auto", device="cuda",
                 device_min_flop: float = 2e7):
        """1-4+PDM; pass bra for transition densities (reference
        pyblock2/driver/core.py:5504 get_npdm / get_trans_1pdm), with the
        reference's routing: orders 1 and 2, and order 3 with algo
        'auto' or 'det', on the host string engine (dmrg/expect.py);
        orders >= 3 otherwise on the determinant engine (algo 'det', or
        'auto' on chains of at most 8 sites; dmrg/npdm.py) or the
        polynomial pooled-sweep engine (algo 'poly', dmrg/npdm_scheme.py),
        whose class closes run on ``device`` ("cuda" by default, kernel
        K17; "cpu" runs its twin; None keeps them on host BLAS), those
        of at least ``device_min_flop`` FLOPs (host BLAS below, as in
        ``pooled_gram``).  A solved
        spin-adapted state (``SU2MPSSpec``, bra too) is expanded to SZ
        first (``trans_mps_to_sz``; reference driver/core.py:697-736 of
        the JAX package), then routed the same way: the spatial PDMs do not
        depend on the projection 2Sz."""
        from ..dmrg.expect import pdm1, pdm2_spatial, pdm3_spatial
        if isinstance(ket, SU2MPSSpec):
            ket = self.trans_mps_to_sz(ket)
        if isinstance(bra, SU2MPSSpec):
            bra = self.trans_mps_to_sz(bra)
        for m in (ket, bra):
            if m is not None and not isinstance(m, MPS):
                raise TypeError(
                    f"get_npdm takes the port's SZ MPS or a solved "
                    f"SU2MPSSpec, got {type(m)}")
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
                                     device=device,
                                     device_min_flop=device_min_flop)
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

    def get_3pdm(self, ket, *, bra=None, algo: str = "auto", device="cuda",
                 device_min_flop: float = 2e7):
        return self.get_npdm(ket, pdm_type=3, bra=bra, algo=algo,
                             device=device, device_min_flop=device_min_flop)

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


# ---------------------------------------------------------------------------
# the SU2 and SAnySU2 modes (copied from the JAX package's
# driver/core.py:1210-1278)
# ---------------------------------------------------------------------------

class SU2MPO:
    """Compiled spin-adapted MPO handle (driver SU2 mode): per-site symbol
    entries + reduced-operator registry for SU2FermionDMRG
    (reference MPOQC<SU2>, src/dmrg/qc_mpo.hpp:1851)."""

    def __init__(self, entries, n_symbols, sym_dn, sym_rank, registry):
        self.entries = entries
        self.n_symbols = n_symbols
        self.sym_dn = sym_dn
        self.sym_rank = sym_rank
        self.registry = registry
        # the SAnySU2 mode's custom sites: per-site multiplets (N, 2S, pg)
        # and per-site operator overrides (a site-local identity "I")
        self.site_mults = None
        self.site_ops = None


class SU2MPSSpec:
    """Deferred spin-adapted MPS: (target, bond_dim, seed); the engine
    materializes the reduced tensors at dmrg() time."""

    def __init__(self, target, bond_dim, seed=7, init_tensors=None,
                 left_vacuum=None):
        self.target = target
        self.bond_dim = bond_dim
        self.seed = seed
        self.engine = None
        # warm start (extract_root tensors; statespecific workflow)
        self.init_tensors = init_tensors
        # singlet embedding (reference core.py:7217): fictitious
        # boundary multiplet, typically (2S, 2S, 0) with the target
        # promoted to (n_elec + 2S, 0, pg)
        self.left_vacuum = left_vacuum


def _su2_qc_mpo(h1e, g2e, ecore) -> SU2MPO:
    from ..dmrg.su2_qc import compile_su2_entries, qc_su2_term_table
    tt = qc_su2_term_table(np.asarray(h1e),
                           None if g2e is None else np.asarray(g2e),
                           float(ecore))
    return SU2MPO(*compile_su2_entries(tt))


def _su2_dmrg(driver, mpo: SU2MPO, ket: SU2MPSSpec, bond_dims, noises,
              thrds, n_sweeps, tol, iprint, n_roots: int = 1,
              proj_mpss=None, proj_weights=None, backend="torch_tiled",
              device="cuda", dtype=np.float64, twodot_to_onedot=None,
              **kw):
    from ..dmrg.su2_fermion import BACKENDS, SU2FermionDMRG
    if backend not in BACKENDS:
        raise ValueError(
            f"backend {backend!r} runs SZ states only; the SU2 mode runs "
            f"{BACKENDS} (torch_tiled: K5 + K7 on the device)")
    if twodot_to_onedot is not None:
        raise NotImplementedError("one-site sweeps are SZ only")
    if kw.get("mesh") is not None:
        raise NotImplementedError(
            "SU(2) under a mesh is roadmap item A6b.5")
    bad = set(kw) - {"mesh"}
    if bad:
        raise TypeError(f"SU2-mode dmrg got unexpected options {sorted(bad)}")
    if not isinstance(mpo, SU2MPO) or not isinstance(ket, SU2MPSSpec):
        raise TypeError("the SU2 and SAnySU2 modes take an SU2MPO (get_qc_mpo"
                        ", or get_mpo of a coupled ExprBuilder table) and "
                        "get_random_mps's SU2MPSSpec")
    proj_tensors = None
    if proj_mpss:
        # accept SU2MPSSpec (solved: .engine set), raw engines, or
        # tensor lists from SU2FermionDMRG.extract_root
        proj_tensors = []
        for p in proj_mpss:
            if isinstance(p, SU2MPSSpec):
                p = p.engine
            proj_tensors.append(p.tensors if hasattr(p, "tensors")
                                else p)
    eng = SU2FermionDMRG(
        driver.n_sites, mpo.entries, mpo.n_symbols, mpo.sym_dn,
        target=ket.target, bond_dim=max(bond_dims), seed=ket.seed,
        iprint=iprint, ops=mpo.registry, ranks=mpo.sym_rank,
        site_mults=mpo.site_mults, site_ops=mpo.site_ops,
        site_pgs=driver.orb_sym, n_roots=n_roots,
        proj_tensors=proj_tensors, proj_weights=proj_weights,
        init_tensors=ket.init_tensors, left_vacuum=ket.left_vacuum,
        pg_mod=driver.pg_mod, backend=backend, exec_dtype=dtype,
        device=device)
    ket.engine = eng
    e = eng.solve(n_sweeps=n_sweeps, tol=tol, noises=list(noises),
                  dav_thrds=list(thrds))
    driver._last_dmrg = eng
    return e
