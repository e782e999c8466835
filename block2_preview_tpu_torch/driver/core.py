"""DMRGDriver of the port: the reference driver with ``dmrg`` running the
port's device-resident DMRG.

Usage is the reference's (pyblock2 style):

    drv = DMRGDriver(symm_type=SymmetryTypes.SZ)
    drv.initialize_system(n_sites=8, n_elec=8, spin=0)
    mpo = drv.get_qc_mpo(h1e=h1e, g2e=g2e, ecore=ecore)
    ket = drv.get_random_mps(bond_dim=80)
    energy = drv.dmrg(mpo, ket, bond_dims=[80], device="cuda")

MPO and MPS construction are the reference's host code, unchanged.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from block2_preview_tpu.driver.core import DMRGDriver as _RefDMRGDriver
from block2_preview_tpu.driver.core import SymmetryTypes

from ..dmrg.sweep import DMRG

__all__ = ["DMRGDriver", "SymmetryTypes"]


class DMRGDriver(_RefDMRGDriver):
    def dmrg(self, mpo, ket, bond_dims: Sequence[int] = (250,),
             noises: Sequence[float] = (1e-4, 1e-5, 0.0),
             thrds: Sequence[float] = (1e-10,), n_sweeps: int = 16,
             tol: float = 1e-9, iprint: int = 1, device=None,
             dtype=np.float64, **kw) -> float:
        """SZ ground-state DMRG with the effective-Hamiltonian step on
        ``device`` (required: 'cuda', 'cuda:0' or 'cpu').  The solver is
        kept as ``self._last_dmrg`` (energies, timings, sweep_log,
        host_redo_count)."""
        if self.symm_type != SymmetryTypes.SZ or \
                getattr(self, "_sany_su2_h", None) is not None:
            raise NotImplementedError("the port runs SZ symmetry only")
        solver = DMRG(mpo, ket, device=device, dtype=dtype, iprint=iprint,
                      **kw)
        e = solver.solve(list(bond_dims), list(noises), list(thrds),
                         n_sweeps=n_sweeps, tol=tol)
        self._last_dmrg = solver
        return e
