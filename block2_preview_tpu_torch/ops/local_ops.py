"""Local site bases and elementary second-quantized operators.

Counterpart of the site-operator factories in block2's
Hamiltonian/GeneralHamiltonian (reference src/core/hamiltonian.hpp:66-97
SiteBasis, src/dmrg/general_hamiltonian.hpp:47 site op production).

SZ mode uses one spatial orbital per site with the 4-dim Fock basis
|0>, |alpha>, |beta>, |2> = c+_a c+_b |0>.  All Jordan-Wigner fermion strings
are materialized into the per-site operator matrices at term-construction time
(core/expr.py), so every downstream tensor contraction is purely bosonic —
this mirrors how block2's symbolic layer confines fermion signs to operator
definitions rather than contraction code.

Copied from block2_preview_tpu/ops/local_ops.py (the port keeps its own copy).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..core.symmetry import QN, SymmetryGroup, SZ_GROUP

# Elementary operator codes (spin orbital ops on a spatial-orbital site)
CRE_A, DES_A, CRE_B, DES_B = 0, 1, 2, 3

# Basis order |0>, |a>, |b>, |2>;  |2> = c+_a c+_b |0>
_CA = np.zeros((4, 4)); _CA[1, 0] = 1.0; _CA[3, 2] = 1.0
_DA = _CA.T.copy()
_CB = np.zeros((4, 4)); _CB[2, 0] = 1.0; _CB[3, 1] = -1.0
_DB = _CB.T.copy()
IDENT = np.eye(4)
PARITY = np.diag([1.0, -1.0, -1.0, 1.0])   # (-1)^n, the JW string operator

ELEM_MATS = {CRE_A: _CA, DES_A: _DA, CRE_B: _CB, DES_B: _DB}

# delta quantum of elementary ops in SZ mode (n, twosz) — pg added per site
ELEM_DQ = {CRE_A: (1, 1), DES_A: (-1, -1), CRE_B: (1, -1), DES_B: (-1, 1)}


def sz_site_basis_quanta(pg: int = 0) -> List[QN]:
    """Quantum numbers of the 4 site-basis states, in basis order."""
    return [(0, 0, 0), (1, 1, pg), (1, -1, pg), (2, 0, 0)]


def op_delta_quantum(group: SymmetryGroup, mat: np.ndarray,
                     site_quanta: List[QN], strict: bool = True):
    """Infer the (unique) delta quantum of a 4x4 site operator from its
    nonzero pattern against the site basis quanta.  Identity-like all-zero
    patterns return the group zero.

    strict=False returns None when the pattern mixes delta quanta —
    used by the MPO builder's per-site tables, where a registry op can
    be probed against a DIFFERENT site's basis that happens to share
    its dimension (heterogeneous big-site chains): mixing there just
    means 'this op never occurs at this site'.

    Accepts CSR operators (big sites, reference
    src/core/csr_sparse_matrix.hpp) — the scan is O(nnz) either way."""
    from .csr import delta_quantum_pairs
    dq = None
    for b, k in delta_quantum_pairs(mat):
        d = group.sub(site_quanta[b], site_quanta[k])
        if dq is None:
            dq = d
        elif dq != d:
            if strict:
                raise AssertionError("operator mixes delta quanta")
            return None
    return dq if dq is not None else group.zero


class OpRegistry:
    """Deduplicating registry of numeric site-operator matrices.

    ids 0 and 1 are reserved for identity and JW parity so that term tables
    can encode pass-through sites compactly."""

    ID_I = 0
    ID_Z = 1

    def __init__(self, ident: np.ndarray = None, parity: np.ndarray = None):
        from .csr import is_sparse, mat_key
        self.mats: List[np.ndarray] = []
        self._index = {}
        ident = IDENT if ident is None else ident
        parity = PARITY if parity is None else parity
        # reserved slots (parity may equal identity for bosonic sites)
        self.mats.append(ident if is_sparse(ident)
                         else np.asarray(ident, dtype=self._dt(ident)))
        self.mats.append(parity if is_sparse(parity)
                         else np.asarray(parity, dtype=self._dt(parity)))
        self._index[mat_key(parity)] = self.ID_Z
        self._index[mat_key(ident)] = self.ID_I

    @staticmethod
    def _dt(mat):
        return np.complex128 if np.iscomplexobj(mat) else np.float64

    def register(self, mat: np.ndarray) -> int:
        from .csr import is_sparse, mat_any, mat_key
        # real-valued complex matrices dedupe against their real twins
        if np.iscomplexobj(mat) and not is_sparse(mat) \
                and not np.any(mat.imag):
            mat = mat.real
        key = mat_key(mat)
        idx = self._index.get(key)
        if idx is None:
            idx = len(self.mats)
            self.mats.append(mat if is_sparse(mat)
                             else np.asarray(mat, dtype=self._dt(mat)))
            self._index[key] = idx
        return idx

    def __getitem__(self, idx: int) -> np.ndarray:
        return self.mats[idx]

    def __len__(self) -> int:
        return len(self.mats)


# ----------------------------------------------------------------------
# Site-basis specifications: each symmetry mode defines its local Hilbert
# space, elementary operators, and JW parity operator (the analog of the
# per-symmetry site bases in reference src/dmrg/general_hamiltonian.hpp).
# ----------------------------------------------------------------------

from dataclasses import dataclass
from typing import Callable, Dict


@dataclass(frozen=True)
class SiteBasisSpec:
    name: str
    dim: int
    elem_mats: Dict[int, np.ndarray]
    ident: np.ndarray
    parity: np.ndarray
    quanta: Callable[[int], List[QN]]    # pg label -> basis quanta
    fermionic: bool = True               # reorder signs + JW strings
    # big sites with particle-number windows: products of the projected
    # elementary matrices clip intermediate states outside the window,
    # so windowed specs provide `compose(elem_ids, z)` building the
    # composite matrix EXACTLY by walking occupancy states (reference
    # csf_big_site.hpp constructs composites before restricting);
    # term_row calls it instead of multiplying elem_mats.
    compose: Callable = None

    def registry(self) -> OpRegistry:
        return OpRegistry(self.ident, self.parity)


SZ_SITE = SiteBasisSpec("sz", 4, ELEM_MATS, IDENT, PARITY,
                        sz_site_basis_quanta)

# SGF: one spin orbital per site, dim 2 (reference symmetry.hpp:591 SGLong;
# used for general-spin / relativistic DHF runs)
_SGF_C = np.zeros((2, 2)); _SGF_C[1, 0] = 1.0
SGF_SITE = SiteBasisSpec(
    "sgf", 2, {CRE_A: _SGF_C, DES_A: _SGF_C.T.copy()},
    np.eye(2), np.diag([1.0, -1.0]),
    lambda pg=0: [(0, 0), (1, pg)])

# SGB: spin-1/2 site (no fermion signs) for Heisenberg-type models
# (reference src/core/heisenberg.hpp:31); ops: S+ = code CRE_A, S- = DES_A,
# 2*Sz = CRE_B code slot
_SP = np.zeros((2, 2)); _SP[0, 1] = 1.0     # S+ |down> = |up>; basis up,down
SGB_SPIN_HALF_SITE = SiteBasisSpec(
    "sgb", 2, {CRE_A: _SP, DES_A: _SP.T.copy(),
               CRE_B: np.diag([1.0, -1.0])},
    np.eye(2), np.eye(2),
    lambda pg=0: [(1,), (-1,)], fermionic=False)
