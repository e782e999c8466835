"""CSR sparse site operators (reference src/core/csr_sparse_matrix.hpp
CSRMatrixRef + src/core/csr_operator_functions.hpp).

Big-site operators (determinant/CSF external spaces) are huge and
ultra-sparse — elementary and composite occupancy-walk operators carry at
most one nonzero per column — so the reference stores big-site operators
CSR and keeps the dense path for ordinary 4-dim sites
(src/big_site/sweep_algorithm_big_site.hpp works on CSRSparseMatrix).
Here the *host-side* operator pipeline (OpRegistry, delta-quantum
inference, MPO tensor assembly, plan builders) accepts
scipy.sparse.csr_matrix transparently; plans densify nothing — they
already consume operators through (rows, cols, values) scans — and the
device kernels see only the scalar coefficients w[pb, pk].

Copied from block2_preview_tpu/ops/csr.py (the port keeps its own copy).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

# dimension at which big-site specs switch their operator matrices to CSR
CSR_SITE_DIM = 128


def is_sparse(mat) -> bool:
    return sp.issparse(mat)


def csr_from_triplets(rows, cols, vals, shape) -> sp.csr_matrix:
    """Composite-operator constructor for occupancy walks (the analog of
    building CSRMatrixRef from the nonzero pattern)."""
    m = sp.csr_matrix((np.asarray(vals, dtype=np.float64),
                       (np.asarray(rows, dtype=np.int64),
                        np.asarray(cols, dtype=np.int64))), shape=shape)
    m.sum_duplicates()
    return m


def sparse_identity(dim: int) -> sp.csr_matrix:
    return sp.identity(dim, dtype=np.float64, format="csr")


def sparse_diag(d: np.ndarray) -> sp.csr_matrix:
    return sp.diags(np.asarray(d, dtype=np.float64), format="csr")


def w_nonzero(mat):
    """(rows, cols) of the nonzero entries — np.nonzero for ndarrays,
    the index arrays for CSR (no densification)."""
    if sp.issparse(mat):
        coo = mat.tocoo()
        return coo.row, coo.col
    return np.nonzero(mat)


def w_triplets(mat):
    """(rows, cols, values) without densifying."""
    if sp.issparse(mat):
        coo = mat.tocoo()
        return coo.row, coo.col, coo.data
    r, c = np.nonzero(mat)
    return r, c, mat[r, c]


def mat_any(mat) -> bool:
    if sp.issparse(mat):
        return mat.count_nonzero() > 0
    return bool(np.any(mat))


def as_dense(mat) -> np.ndarray:
    if sp.issparse(mat):
        return mat.toarray()
    return np.asarray(mat)


def mat_key(mat) -> bytes:
    """Content key for OpRegistry dedup; CSR keys on the canonicalized
    (indptr, indices, rounded data) triplet so a CSR operator and its
    dense twin at the same registry are distinct only by storage class
    (big-site dims never collide with small-site dims anyway)."""
    if sp.issparse(mat):
        m = mat.tocsr()
        m.sum_duplicates()
        return (b"csr" + np.asarray(m.shape, np.int64).tobytes()
                + m.indptr.tobytes() + m.indices.tobytes()
                + np.round(m.data, 14).tobytes())
    return np.round(mat, 14).tobytes()


def delta_quantum_pairs(mat):
    """(bra_index, ket_index) pairs of the nonzero pattern for
    delta-quantum inference — O(nnz) instead of the dense double loop."""
    r, c = w_nonzero(mat)
    return zip(r.tolist(), c.tolist())
