"""Exact-diagonalization harness for validating term tables and MPOs.

Plays the role of the reference's dense cross-checks (block2 validates its
DMRG against FCI energies computed with pyscf in pyblock2/unit_test/dmrg.py);
here we build the many-body Hamiltonian directly from the packed TermTable,
restrict it to a (N, 2Sz) charge sector, and diagonalize.  Because the MPO
builder consumes the same TermTable, any disagreement between ED and DMRG
isolates a bug in the MPO/sweep layers, while agreement with block2's
hard-coded reference energies validates the term conventions end to end.

Copied from block2_preview_tpu/utils/ed.py (the port keeps its own copy):
the exact oracle of ``utils/gpu_smoke.py``'s tiled-solve probe.
"""

from __future__ import annotations

from functools import reduce
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from ..core.expr import TermTable
from ..ops.local_ops import sz_site_basis_quanta


def term_table_to_sparse(tt: TermTable) -> sp.csr_matrix:
    """Full d^L x d^L many-body matrix. Only for small systems."""
    L = tt.n_sites
    d = tt.registry[0].shape[0]
    dim = d ** L
    h = sp.csr_matrix((dim, dim))
    for coeff, row in zip(tt.coeffs, tt.opids):
        mats = [sp.csr_matrix(tt.registry[int(op)]) for op in row]
        term = reduce(lambda a, b: sp.kron(a, b, format="csr"), mats)
        h = h + coeff * term
    return h


def sector_indices(L: int, n_elec: int, twos: Optional[int] = None,
                   quanta=None) -> np.ndarray:
    """Indices of product-basis states with given particle number (and 2Sz
    when tracked).  Site-major ordering matches term_table_to_sparse."""
    quanta = quanta if quanta is not None else sz_site_basis_quanta()
    n_site = np.array([q[0] for q in quanta])
    n_tot = np.zeros(1, dtype=np.int64)
    if twos is not None and len(quanta[0]) > 2:
        sz_site = np.array([q[1] for q in quanta])
        sz_tot = np.zeros(1, dtype=np.int64)
        for _ in range(L):
            n_tot = (n_tot[:, None] + n_site[None, :]).ravel()
            sz_tot = (sz_tot[:, None] + sz_site[None, :]).ravel()
        return np.nonzero((n_tot == n_elec) & (sz_tot == twos))[0]
    for _ in range(L):
        n_tot = (n_tot[:, None] + n_site[None, :]).ravel()
    return np.nonzero(n_tot == n_elec)[0]


def ground_state_energy(tt: TermTable, n_elec: int, twos: int,
                        const_e: float = 0.0, k: int = 1) -> np.ndarray:
    """Lowest k eigenvalues in the (n_elec, twos) sector, including const_e."""
    h = term_table_to_sparse(tt)
    ix = sector_indices(tt.n_sites, n_elec, twos)
    hs = h[np.ix_(ix, ix)]
    if hs.shape[0] <= 400:
        w = np.linalg.eigvalsh(hs.toarray())
        return w[:k] + const_e
    w = spla.eigsh(hs, k=k, which="SA", return_eigenvectors=False)
    return np.sort(w) + const_e
