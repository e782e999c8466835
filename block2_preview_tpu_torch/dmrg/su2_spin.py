"""SU(2) coupling factors of the spin-adapted engines.

Copied from block2_preview_tpu/dmrg/su2_spin.py:44-58 (the port keeps its
own copy): ``coupled_factor``, the reduced element of a coupled operator
product on a Clebsch-Gordan-fused pair basis, which the fermionic engine
(``dmrg/su2_fermion.py``) and its blocking plans (``ops/su2blk.py``) bake
into their coefficients, and ``spin_reduced_element``.  The spin-chain
engine of that module (``SU2SpinDMRG``) is not ported yet (ROADMAP A6b).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..core.clebsch_gordan import wigner_9j


@lru_cache(maxsize=1 << 20)
def coupled_factor(ja, jb, j, k1, k2, k, jap, jbp, jp) -> float:
    """Reduced element of [A^{k1} x B^{k2}]^{k} on a CG-fused pair basis,
    divided by <A><B>.  Doubled spins.  Hot in the SU(2) QC engine
    (hundreds of thousands of lookups per sweep) — cached whole, not just
    the 9j part, to skip the sqrt arithmetic too."""
    return float(
        np.sqrt((j + 1.0) * (k + 1.0) * (jap + 1.0) * (jbp + 1.0))
        * wigner_9j(ja, jb, j, k1, k2, k, jap, jbp, jp))


def spin_reduced_element(tj: int = 1) -> float:
    """<s||S||s> = sqrt(s(s+1)); from <s s|Sz|s s> = s via Wigner-Eckart."""
    s = tj / 2.0
    return np.sqrt(s * (s + 1.0))
