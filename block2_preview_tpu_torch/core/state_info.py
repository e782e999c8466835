"""StateInfo: sorted (quantum number -> multiplicity) maps for basis/bond spaces.

Counterpart of block2's StateInfo<S> (reference
src/core/state_info.hpp:59) including tensor products with target-reachability
filtering (state_info.hpp:229-311).  These are host-side objects consumed by
the contraction-plan compiler; on device only their dims/offsets survive.

Copied from block2_preview_tpu/core/state_info.py (the port keeps its own copy).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

from .symmetry import QN, SymmetryGroup


class StateInfo:
    """Ordered map {quantum number: multiplicity} describing a Hilbert space."""

    __slots__ = ("group", "quanta")

    def __init__(self, group: SymmetryGroup, quanta: Dict[QN, int] | None = None):
        self.group = group
        self.quanta: Dict[QN, int] = {}
        if quanta:
            for q in sorted(quanta):
                n = int(quanta[q])
                if n > 0:
                    self.quanta[q] = n

    # -- basic ----------------------------------------------------------
    def __contains__(self, q: QN) -> bool:
        return q in self.quanta

    def __getitem__(self, q: QN) -> int:
        return self.quanta[q]

    def get(self, q: QN, default: int = 0) -> int:
        return self.quanta.get(q, default)

    def __iter__(self):
        return iter(self.quanta)

    def items(self):
        return self.quanta.items()

    def __len__(self) -> int:
        return len(self.quanta)

    @property
    def n_states_total(self) -> int:
        return sum(self.quanta.values())

    def __repr__(self) -> str:
        inner = ", ".join(f"{q}:{n}" for q, n in self.quanta.items())
        return f"StateInfo({inner})"

    def __eq__(self, other) -> bool:
        return isinstance(other, StateInfo) and self.quanta == other.quanta

    def copy(self) -> "StateInfo":
        return StateInfo(self.group, dict(self.quanta))

    # -- constructors ----------------------------------------------------
    @staticmethod
    def vacuum(group: SymmetryGroup) -> "StateInfo":
        return StateInfo(group, {group.zero: 1})

    @staticmethod
    def single(group: SymmetryGroup, q: QN) -> "StateInfo":
        return StateInfo(group, {q: 1})

    # -- algebra ----------------------------------------------------------
    def tensor_product(self, other: "StateInfo") -> "StateInfo":
        """Full tensor product (reference state_info.hpp:229 tensor_product)."""
        g = self.group
        out: Dict[QN, int] = {}
        for qa, na in self.quanta.items():
            for qb, nb in other.quanta.items():
                q = g.add(qa, qb)
                out[q] = out.get(q, 0) + na * nb
        return StateInfo(g, out)

    def filter_against(self, other: "StateInfo", target: QN) -> "StateInfo":
        """Keep only quanta q such that target - q exists in `other`, and cap
        multiplicity by the number of compatible partner states
        (reference state_info.hpp:311 filter)."""
        g = self.group
        out: Dict[QN, int] = {}
        for q, n in self.quanta.items():
            need = g.sub(target, q)
            m = other.get(need, 0)
            if m > 0:
                out[q] = min(n, m)
        return StateInfo(g, out)

    def cap(self, cap_info: "StateInfo") -> "StateInfo":
        """Per-sector cap of multiplicities (used for FCI-bounded bond dims)."""
        out = {q: min(n, cap_info.get(q, 0)) for q, n in self.quanta.items()}
        return StateInfo(self.group, out)

    def truncate_total(self, max_total: int) -> "StateInfo":
        """Proportionally shrink sector multiplicities so the total is at most
        max_total, keeping every sector populated with >=1 state (the behavior
        of MPSInfo::set_bond_dimension, reference src/dmrg/mps.hpp:609)."""
        total = self.n_states_total
        if total <= max_total:
            return self.copy()
        out: Dict[QN, int] = {}
        for q, n in self.quanta.items():
            out[q] = max(1, int(round(n * max_total / total)))
        return StateInfo(self.group, out)
