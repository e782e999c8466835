"""Symbolic operator terms as packed numeric term tables.

Counterpart of block2's expression layer (reference
src/core/expr.hpp:151-888 OpElement/OpProduct/OpSum and
src/core/integral_general.hpp:45 GeneralFCIDUMP).  Where the reference keeps
a symbolic DAG of second-quantized operators, we normal-order every term by
site, fold the Jordan-Wigner strings into per-site 4x4 matrices, and store the
whole Hamiltonian as a packed (coeff[n], opid[n, L]) numpy table.  This table
is the single input of the MPO builder (dmrg/mpo_builder.py) and the exact-
diagonalization harness (utils/ed.py), so operator conventions live in exactly
one place.

Copied from block2_preview_tpu/core/expr.py (the port keeps its own copy).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..core.fcidump import FCIDUMP
from ..core.symmetry import SymmetryGroup, SZ_GROUP
from ..ops.local_ops import (CRE_A, CRE_B, DES_A, DES_B, OpRegistry, SZ_SITE,
                             SiteBasisSpec)

RawTerm = Tuple[float, Sequence[Tuple[int, int]]]   # (coeff, [(site, elem), ...])


@dataclass
class TermTable:
    """Packed table of normal-ordered operator strings.

    coeffs[n]        term coefficients (signs from fermion reordering folded in)
    opids[n, L]      per-site operator ids into `registry` (JW parity folded in)
    registry         id -> 4x4 site matrix
    """

    group: SymmetryGroup
    n_sites: int
    coeffs: np.ndarray
    opids: np.ndarray
    registry: OpRegistry

    def __len__(self) -> int:
        return len(self.coeffs)

    def deduplicate(self, cutoff: float = 0.0) -> "TermTable":
        """Merge identical operator strings, drop negligible coefficients."""
        rows, inv = np.unique(self.opids, axis=0, return_inverse=True)
        coeffs = np.zeros(len(rows), dtype=self.coeffs.dtype)
        np.add.at(coeffs, inv.ravel(), self.coeffs)
        keep = np.abs(coeffs) > cutoff
        return TermTable(self.group, self.n_sites, coeffs[keep], rows[keep],
                         self.registry)


def _inversion_parity(seq: Sequence[int]) -> int:
    """Parity of the permutation that stably sorts `seq` ascending."""
    inv = 0
    for i in range(len(seq)):
        for j in range(i + 1, len(seq)):
            if seq[i] > seq[j]:
                inv += 1
    return inv & 1


def term_row(n_sites: int, coeff: float, ops: Sequence[Tuple[int, int]],
             registry: OpRegistry,
             spec: SiteBasisSpec = SZ_SITE
             ) -> Optional[Tuple[float, np.ndarray]]:
    """Normal-order one raw operator string by site, folding the Jordan-Wigner
    string into per-site matrices.

    For a term O_{s1} O_{s2} ... O_{sk} with all elementary ops fermionic and
    sites sorted ascending, the many-body operator factorizes as
    (x)_t M_t with  M_t = (product of local ops at t, in term order) @ Z^{m_t}
    where m_t = number of elementary ops at sites > t (JW convention with
    site-major spin-orbital ordering; matches block2's SZ operator algebra,
    reference src/dmrg/qc_hamiltonian.hpp:40 site op definitions).

    spec may also be a per-site sequence of SiteBasisSpec (heterogeneous
    chains with big sites, reference src/big_site/big_site.hpp); each
    site's elementary ids index into its own elem_mats.

    Returns (signed coefficient, opid row) or None if the term vanishes.
    """
    per_site_spec = not isinstance(spec, SiteBasisSpec)
    spec0 = spec[0] if per_site_spec else spec
    sites = [s for s, _ in ops]
    sign = -1.0 if (spec0.fermionic and _inversion_parity(sites)) else 1.0
    order = sorted(range(len(ops)), key=lambda i: sites[i])
    per_site: dict = {}
    for i in order:
        per_site.setdefault(sites[i], []).append(ops[i][1])
    row = np.zeros(n_sites, dtype=np.uint32)
    n_right = len(ops)
    for t in range(n_sites):
        here = per_site.get(t)
        if here is None:
            row[t] = OpRegistry.ID_Z if (n_right & 1) else OpRegistry.ID_I
            continue
        st = spec[t] if per_site_spec else spec
        n_right -= len(here)
        if st.compose is not None:
            # windowed big site: exact composite via occupancy walks
            # (projected-elementary products would clip intermediates
            # outside the particle-number window)
            mat = st.compose(tuple(here), bool(n_right & 1))
        else:
            mat = st.elem_mats[here[0]]
            for e in here[1:]:
                mat = mat @ st.elem_mats[e]
            if n_right & 1:
                mat = mat @ st.parity
        from ..ops.csr import mat_any
        if not mat_any(mat):
            return None
        row[t] = registry.register(mat)
    return sign * coeff, row


def build_term_table(n_sites: int, raw_terms: Iterable[RawTerm],
                     group: SymmetryGroup = SZ_GROUP,
                     registry: Optional[OpRegistry] = None,
                     cutoff: float = 1e-14,
                     spec: SiteBasisSpec = SZ_SITE) -> TermTable:
    """Normal-order raw operator strings into a packed, deduplicated table."""
    registry = registry or \
        (spec if isinstance(spec, SiteBasisSpec) else spec[0]).registry()
    coeff_rows: List[float] = []
    opid_rows: List[np.ndarray] = []
    for coeff, ops in raw_terms:
        if coeff == 0.0:
            continue
        res = term_row(n_sites, coeff, ops, registry, spec=spec)
        if res is None:
            continue
        coeff_rows.append(res[0])
        opid_rows.append(res[1])
    if not coeff_rows:
        return TermTable(group, n_sites, np.zeros(0),
                         np.zeros((0, n_sites), dtype=np.uint32), registry)
    tt = TermTable(group, n_sites, np.array(coeff_rows),
                   np.stack(opid_rows), registry)
    return tt.deduplicate(cutoff)


# ----------------------------------------------------------------------
# Quantum-chemistry Hamiltonian -> raw terms (spin-orbital expansion)
# ----------------------------------------------------------------------

def qc_raw_terms(fd: FCIDUMP, cutoff: float = 1e-13,
                 pg_mode: object = "xor") -> List[RawTerm]:
    """Expand H = sum_{s,ij} h_ij c+_is c_js
               + 1/2 sum_{st,ijkl} (ij|kl) c+_is c+_kt c_lt c_js
    into elementary operator strings (chemist-notation integrals, matching
    block2's FCIDUMP semantics, reference src/core/integral.hpp:540).
    """
    terms: List[RawTerm] = []
    spins = ((CRE_A, DES_A), (CRE_B, DES_B))
    if not fd.uhf:
        h1e, g2e = fd.h1e, fd.g2e
        h1 = (h1e, h1e)
        v_sections = [(0, 0, 0.5, g2e), (1, 1, 0.5, g2e),
                      (0, 1, 0.5, g2e), (1, 0, 0.5, g2e)]
    else:
        ha, hb = fd.h1e
        vaa, vbb, vab = fd.g2e
        h1 = (ha, hb)
        vba = vab.transpose(2, 3, 0, 1)
        v_sections = [(0, 0, 0.5, vaa), (1, 1, 0.5, vbb),
                      (0, 1, 0.5, vab), (1, 0, 0.5, vba)]
    # symmetry filter on orbital labels: "xor" (D2h point groups), an int L
    # (mod-L momentum conservation with +k for creation, -k annihilation),
    # "lz" (plain-integer additive conservation on fd.k_sym — the SZLZ mode,
    # reference symmetry.hpp:864), or "none"
    pg = None
    if pg_mode == "lz":
        pg = np.asarray(fd.k_sym if fd.k_sym is not None else fd.orb_sym,
                        dtype=np.int64)
    elif pg_mode != "none" and fd.orb_sym is not None and np.any(fd.orb_sym):
        pg = np.asarray(fd.orb_sym, dtype=np.int64)

    def keep1(i, j):
        if pg is None:
            return True
        if pg_mode == "xor":
            return (pg[i] ^ pg[j]) == 0
        if pg_mode == "lz":
            return pg[i] - pg[j] == 0
        return (pg[i] - pg[j]) % int(pg_mode) == 0

    def keep2(i, j, k, l):
        if pg is None:
            return True
        if pg_mode == "xor":
            return (pg[i] ^ pg[j] ^ pg[k] ^ pg[l]) == 0
        if pg_mode == "lz":
            return pg[i] - pg[j] + pg[k] - pg[l] == 0
        return (pg[i] - pg[j] + pg[k] - pg[l]) % int(pg_mode) == 0

    for s in (0, 1):
        cre, des = spins[s]
        hh = h1[s]
        for i, j in zip(*np.nonzero(np.abs(hh) > cutoff)):
            if not keep1(i, j):
                continue
            terms.append((float(hh[i, j]), [(int(i), cre), (int(j), des)]))
    for s, t, w, v in v_sections:
        cre_s, des_s = spins[s]
        cre_t, des_t = spins[t]
        idx = np.nonzero(np.abs(v) > cutoff)
        vals = v[idx]
        for (i, j, k, l), val in zip(zip(*idx), vals):
            if not keep2(i, j, k, l):
                continue
            terms.append((w * float(val),
                          [(int(i), cre_s), (int(k), cre_t),
                           (int(l), des_t), (int(j), des_s)]))
    return terms


def qc_term_table(fd: FCIDUMP, group: SymmetryGroup = SZ_GROUP,
                  cutoff: float = 1e-13) -> TermTable:
    if not fd.uhf and fd.n_sites > 16 and fd.h1e is not None:
        # large orbital counts: the vectorized generator (identical output,
        # ~10x faster; falls back automatically for UHF/general cases)
        from .qc_terms_fast import qc_term_table_fast
        return qc_term_table_fast(fd, group=group, cutoff=cutoff)
    return build_term_table(fd.n_sites, qc_raw_terms(fd, cutoff), group=group)
