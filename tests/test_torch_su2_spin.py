"""The port's spin-chain engine (block2_preview_tpu_torch/dmrg/su2_spin.py:
``heisenberg_entries``, ``SU2SpinDMRG``, ``SU2HeisenbergDMRG``; the
``su2_heisenberg`` module name) against the JAX package's on the same
chains, sweep by sweep to 1e-10 Ha, and against ED to 1e-8 Ha: the
spin-1/2 chain at L=2 and L=4, the spin-1 (Haldane) chain at L=6 and the
lowest triplet at L=6.  Host numpy with the host Davidson, as in the JAX
package: no kernel launches.  Mirrors tests/test_su2.py."""

import numpy as np
import pytest

from block2_preview_tpu.dmrg import su2_heisenberg as ref_heis

from block2_preview_tpu_torch.dmrg import su2_heisenberg, su2_spin
from block2_preview_tpu_torch.ops import _kernels

import test_torch_plans  # noqa: F401  (pins torch to one thread)

E_TOL = 1e-8       # Ha, against ED
REF_TOL = 1e-10    # Ha, per sweep against the JAX package's engine


def spin_mats(tj):
    """S_z, S_+ on the |tj, m> basis ordered m = -tj..tj (doubled)."""
    d = tj + 1
    j = tj / 2.0
    sz = np.diag([(-tj + 2 * i) / 2.0 for i in range(d)])
    sp = np.zeros((d, d))
    for i in range(d - 1):
        m = (-tj + 2 * i) / 2.0
        sp[i + 1, i] = np.sqrt(j * (j + 1) - m * (m + 1))
    return sz, sp


def heisenberg_ed(L, tj, tsz=0):
    """Lowest eigenvalue of the open chain in the total Sz = tsz/2 sector."""
    sz, sp = spin_mats(tj)
    d = tj + 1

    def site(op, i):
        out = np.eye(1)
        for t in range(L):
            out = np.kron(out, op if t == i else np.eye(d))
        return out

    H = sum(site(sz, i) @ site(sz, i + 1)
            + 0.5 * (site(sp, i) @ site(sp.T, i + 1)
                     + site(sp.T, i) @ site(sp, i + 1))
            for i in range(L - 1))
    mask = np.abs(np.diag(sum(site(sz, i) for i in range(L)))
                  - tsz / 2.0) < 1e-9
    return float(np.linalg.eigvalsh(H[np.ix_(mask, mask)])[0])


def test_entries_and_reduced_elements_equal_reference():
    for tj in (1, 2, 3):
        assert su2_spin.spin_reduced_element(tj) == \
            ref_heis.spin_reduced_element(tj)
        assert su2_spin.heisenberg_entries(0.7, tj) == \
            ref_heis.heisenberg_entries(0.7, tj)
    assert su2_heisenberg.SU2SpinDMRG is su2_spin.SU2SpinDMRG
    assert su2_heisenberg.coupled_factor is su2_spin.coupled_factor


# (L, D, site 2S, target 2S, sweeps, Sz of the ED sector)
CHAINS = {"l2": (2, 4, 1, 0, 1, 0), "l4": (4, 16, 1, 0, 4, 0),
          "spin1_haldane": (6, 40, 2, 0, 5, 0),
          "triplet": (6, 32, 1, 2, 5, 2)}


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_heisenberg_chains_match_reference_and_ed(name):
    """tests/test_su2.py:124-195: the same chain on both packages' engines
    (equal per sweep) and against ED; the energies flow through the
    port's host Davidson and launch no kernel."""
    L, D, tjs, tt, ns, tsz = CHAINS[name]
    _kernels.reset_counts()
    eng = su2_heisenberg.SU2HeisenbergDMRG(L, bond_dim=D, tj_site=tjs,
                                           target_tj=tt)
    ref = ref_heis.SU2HeisenbergDMRG(L, bond_dim=D, tj_site=tjs,
                                     target_tj=tt)
    e, er = eng.solve(n_sweeps=ns), ref.solve(n_sweeps=ns)
    assert len(eng.energies) == len(ref.energies)
    assert np.abs(np.subtract(eng.energies, ref.energies)).max() <= REF_TOL
    assert abs(e - er) <= REF_TOL
    assert abs(e - (-0.75 if name == "l2" else heisenberg_ed(L, tjs, tsz))) \
        <= E_TOL
    assert not any(_kernels.launch_counts().values())


def test_custom_spin_entries_and_ambiguous_rank():
    """SU2SpinDMRG on hand-written entries (a J1-J2 chain's nearest bonds
    scaled) equals the JAX engine; a symbol whose rank cannot be
    propagated raises, as in the reference."""
    ents, ns = su2_spin.heisenberg_entries(0.5)
    e = su2_spin.SU2SpinDMRG(6, ents, ns, bond_dim=20).solve(n_sweeps=4)
    er = ref_heis.SU2SpinDMRG(6, ents, ns, bond_dim=20).solve(n_sweeps=4)
    assert abs(e - er) <= REF_TOL
    assert abs(e - 0.5 * heisenberg_ed(6, 1)) <= E_TOL
    red = su2_spin.spin_reduced_element(1)
    bad = [(0, 0, 0, 1.0, 1.0), (0, 1, 2, red, 1.0), (1, 2, 2, red, 1.0),
           (2, 3, 2, red, 1.0), (3, 3, 0, 1.0, 1.0)]
    with pytest.raises(ValueError, match="ambiguous"):
        su2_spin.SU2SpinDMRG(4, bad, 4)
