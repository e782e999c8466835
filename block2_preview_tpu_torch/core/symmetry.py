"""Abelian symmetry groups and quantum-number arithmetic.

Counterpart of block2's quantum-number structs (reference
src/core/symmetry.hpp:447-1621: SZ/SGF/SGB/... and the runtime-composable
SAny at symmetry.hpp:58).  Instead of bit-packed C++ structs we use plain
Python int tuples (hashable, used only at plan-compile time on the host;
device code never sees quantum numbers, only padded block buckets).

A quantum number is a tuple of ints, one entry per group factor.  Factors are
either 'u1' (integer addition: particle number N, 2*Sz, 2*S, Lz, K) or 'xor'
(bitwise XOR: the D2h point-group subgroups are all (Z2)^k, matching block2's
XOR-based PointGroup, reference src/core/point_group.hpp).

SU(2) (non-abelian) is layered on top later; its bookkeeping reuses these
tuples with a 'u1'-like 2S factor plus Clebsch-Gordan data (clebsch_gordan.py).

Copied from block2_preview_tpu/core/symmetry.py (the port keeps its own copy).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

QN = Tuple[int, ...]


@dataclass(frozen=True)
class SymmetryGroup:
    """A product of abelian factors. Mirrors block2's SAny in spirit
    (reference src/core/symmetry.hpp:58) but host-side only.

    Factor kinds: 'u1' (integer addition), 'xor' (Z2^k point groups), or
    'modN' for an N-element cyclic factor (K-point momentum, the SZK/LZ
    family of the reference, symmetry.hpp:738 SZKLong)."""

    kinds: Tuple[str, ...]          # each 'u1', 'xor', or 'modN'
    names: Tuple[str, ...]
    fermion_index: int = 0          # which factor is particle number (parity)

    def __post_init__(self):
        assert len(self.kinds) == len(self.names)
        for k in self.kinds:
            assert k in ("u1", "xor") or \
                (k.startswith("mod") and int(k[3:]) > 0), k

    @property
    def zero(self) -> QN:
        return (0,) * len(self.kinds)

    def add(self, a: QN, b: QN) -> QN:
        out = []
        for x, y, k in zip(a, b, self.kinds):
            if k == "u1":
                out.append(x + y)
            elif k == "xor":
                out.append(x ^ y)
            else:
                out.append((x + y) % int(k[3:]))
        return tuple(out)

    def neg(self, a: QN) -> QN:
        out = []
        for x, k in zip(a, self.kinds):
            if k == "u1":
                out.append(-x)
            elif k == "xor":
                out.append(x)
            else:
                out.append((-x) % int(k[3:]))
        return tuple(out)

    def sub(self, a: QN, b: QN) -> QN:
        return self.add(a, self.neg(b))

    def is_fermion(self, a: QN) -> bool:
        return bool(a[self.fermion_index] & 1)


# SZ mode: (N, 2*Sz, pg)  — reference src/core/symmetry.hpp:516 (SZLong)
SZ_GROUP = SymmetryGroup(("u1", "u1", "xor"), ("n", "twosz", "pg"))

# SZ without point group (C1): (N, 2*Sz)
NOPG_SZ_GROUP = SymmetryGroup(("u1", "u1"), ("n", "twosz"))

# SGF (general spin fermion / spin orbitals): (N, pg)
# reference src/core/symmetry.hpp:591 (SGLong)
SGF_GROUP = SymmetryGroup(("u1", "xor"), ("n", "pg"))
