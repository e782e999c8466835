"""Numeric symbol-sparse MPO.

Counterpart of block2's MPO<S,FL> (reference src/dmrg/mpo.hpp:125).
Where the reference keeps per-site Symbolic matrices of operator *names* plus
an OperatorTensor mapping names to SparseMatrix data, we store per site a
sparse map {(in_symbol, out_symbol) -> dense (d_phys x d_phys) matrix}; each
bond symbol carries a definite delta quantum (its operator-prefix charge).
This is equivalent information — a bond symbol IS a (complementary) operator
label — but numeric from the start, which is what the contraction-plan
compiler wants.

Copied from block2_preview_tpu/dmrg/mpo.py (the port keeps its own copy).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from ..core.symmetry import QN, SymmetryGroup


@dataclass
class MPO:
    group: SymmetryGroup
    n_sites: int
    # physical basis quanta per site, in basis order
    site_quanta: List[List[QN]]
    # bond_dqs[b][s] = delta quantum (prefix charge) of symbol s at bond b;
    # bonds 0 and n_sites are singletons
    bond_dqs: List[List[QN]]
    # tensors[t][(in_sym, out_sym)] = (d_phys, d_phys) ndarray
    tensors: List[Dict[Tuple[int, int], np.ndarray]]
    const_e: float = 0.0

    @property
    def bond_dims(self) -> List[int]:
        return [len(d) for d in self.bond_dqs]

    def to_dense(self) -> np.ndarray:
        """Contract the full MPO to a dense many-body matrix (tests only)."""
        d0 = 1
        acc = {0: np.ones((1, 1))}
        for t in range(self.n_sites):
            new: Dict[int, np.ndarray] = {}
            for (i, o), w in self.tensors[t].items():
                if i not in acc:
                    continue
                contrib = np.kron(acc[i], w)
                if o in new:
                    new[o] = new[o] + contrib
                else:
                    new[o] = contrib
            acc = new
        assert set(acc) <= {0}
        dim = 1
        for qs in self.site_quanta:
            dim *= len(qs)
        return acc.get(0, np.zeros((dim, dim)))
