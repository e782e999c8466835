"""Two-site DMRG on the port's device-resident step.

``DMRG`` subclasses the reference driver (block2_preview_tpu/dmrg/
sweep.py:379) and replaces ``update_two_dot`` (reference :710-889): every
two-site step runs through the port's :class:`ResidentSite` — LW/RW mix,
diagonal, sigma matvec and Davidson on the device, for every site and
size.  The rest of the step is the reference's host code: environment
blocking (the host environment maps of backend="numpy"), the perturbative
noise term (from LW/RW downloaded by ``host_ops``) and the decimation.
Those are this slice's boundary, not fallbacks.

Guards carried from the reference (sweep.py:752-790): in float32 a Ritz
pair whose residual ``||Hx - th x||`` exceeds 1.0 Ha is rejected, as is a
site energy below B2TPU_E_FLOOR when that is set.  On a CUDA device a
rejected pair raises, naming the site, theta and the failed check.  Only on
CPU tensors is the site redone by the reference's host solver in
float64; each such redo adds one to ``host_redo_count``.
"""

from __future__ import annotations

import os
import time
from typing import List, Tuple

import numpy as np

from block2_preview_tpu.dmrg.effective import EffectiveHamiltonian2
from block2_preview_tpu.dmrg.sweep import (DMRG as _RefDMRG,
                                           _bond_window, _eff_flops,
                                           split_backward_update,
                                           split_forward_update)

from ..ops.resident import ResidentSite
from ..runtime import resolve_device, torch_dtype


# f32 Ritz guard: a spurious f32 Ritz pair has a residual at least its
# eigenvalue error (Ha-scale); a true one sits at the f32 convergence floor
_GUARD_HA = 1.0


class _DeviceEigenRejected(Exception):
    """An eigenpair of CPU tensors failed a guard; the site is redone by
    the host solver."""


class DMRG(_RefDMRG):
    """SZ two-site ground-state DMRG with the effective-Hamiltonian step
    on ``device`` (explicit: 'cuda', 'cuda:0' or 'cpu')."""

    def __init__(self, mpo, mps, device, dtype=np.float64, iprint: int = 1,
                 dav_max_iter: int = 200, **kw):
        for k in ("backend", "n_roots", "hermitian", "proj_mpss", "mesh"):
            if k in kw:
                raise TypeError(f"{k!r} is not supported by the port "
                                "(single-root Hermitian ground state)")
        torch_dtype(dtype)
        self.device = resolve_device(device)
        # backend="numpy": host environment maps, no JAX anywhere
        super().__init__(mpo, mps, backend="numpy", iprint=iprint,
                         dtype=dtype, dav_max_iter=dav_max_iter, **kw)
        self.backend = "torch_resident"
        self._res_caches = {}
        self.host_redo_count = 0
        # per sweep: (energy, wall s, teff, teig, tdm, tblk)
        self.sweep_log: List[Tuple[float, ...]] = []

    def sweep(self, forward: bool, bond_dim: int, noise: float,
              dav_thrd: float, dot: int = 2):
        tm = self.timings
        before = (tm.teff, tm.teig, tm.tdm, tm.tblk)
        t0 = time.time()
        res = super().sweep(forward, bond_dim, noise, dav_thrd, dot=dot)
        wall = time.time() - t0
        after = (tm.teff, tm.teig, tm.tdm, tm.tblk)
        e = float(np.stack(res.energies).min()) if res.energies \
            else float("nan")
        self.sweep_log.append((e, wall) + tuple(
            a - b for a, b in zip(after, before)))
        return res

    def _guard(self, rs: ResidentSite, th: float, xv: np.ndarray, t: int):
        """Check the eigenpair of site t against the f32 Ritz-residual
        guard and the variational floor.  A failure raises RuntimeError on
        a CUDA device and _DeviceEigenRejected on CPU tensors."""
        why = None
        if np.dtype(self.dtype) == np.float32:
            resid = float(np.linalg.norm(rs.matvec(xv) - th * xv))
            if resid > _GUARD_HA:
                why = (f"Ritz residual {resid:.3e} > {_GUARD_HA} Ha "
                       f"(theta {th:.10f})")
        floor = os.environ.get("B2TPU_E_FLOOR")
        if why is None and floor is not None \
                and th + self.mpo.const_e < float(floor):
            why = (f"energy {th + self.mpo.const_e:.10f} below "
                   f"B2TPU_E_FLOOR {float(floor):.10f} (theta {th:.10f})")
        if why is None:
            return
        msg = f"eigenpair of site {t} rejected: {why}"
        if self.device.type != "cpu":
            raise RuntimeError(f"{msg} on {self.device}")
        if self.iprint >= 2:
            print(f"      [guard] {msg}; redoing on the host in f64",
                  flush=True)
        raise _DeviceEigenRejected(msg)

    def update_two_dot(self, t: int, forward: bool, bond_dim: int,
                       noise: float, dav_thrd: float):
        tm = self.timings
        t0 = time.time()
        eff = EffectiveHamiltonian2(
            self.me, t, key_filter=_bond_window(self.mps.info, t + 1),
            assemble=False)
        rs = ResidentSite(self.me, eff, self.device, dtype=self.dtype,
                          caches=self._res_caches)
        x0 = self._initial_guesses(eff, t)
        t1 = time.time()
        tm.teff += t1 - t0
        th, xv, nmv = rs.solve_ground_state(
            x0[:, 0], conv_thrd=dav_thrd,
            max_iter=self.dav_soft_max_iter or self.dav_max_iter)
        try:
            self._guard(rs, th, xv, t)
        except _DeviceEigenRejected:
            # CPU tensors only: the reference's host solver redoes the site
            self.host_redo_count += 1
            eff.ensure_assembled()
            w, v, nmv = self._solve_eff(eff, x0, eff.diagonal(), dav_thrd)
            self._last_flop = _eff_flops(eff) * nmv
        else:
            w, v = np.array([th]), xv[:, None]
            self._last_flop = float(rs.ex.struct["flops"]) * nmv
            if noise > 0:
                # host noise term from the downloaded LW/RW operators
                if forward:
                    eff.LW = rs.host_ops("lw")
                else:
                    eff.RW = rs.host_ops("rw")
        t2 = time.time()
        tm.teig += t2 - t1
        energies = w[:1] + self.mpo.const_e
        psis = [eff.unflatten(v[:, 0])]
        spectra = [] if self.store_wfn_spectra else None
        if forward:
            a_tensor, centers, dw = split_forward_update(
                eff, psis, self.weights, noise, bond_dim,
                allowed=_bond_window(self.mps.info, t + 1),
                decomp_type=self.decomp_type,
                trunc_cutoff=self.trunc_cutoff, keep_out=spectra)
            t3 = time.time()
            tm.tdm += t3 - t2
            self.mps.tensors[t] = a_tensor
            self.mps.tensors[t + 1] = centers[0]
            self._center_tensors = centers
            self._center_pos = t + 1
            self.me.update_left(t)
            self.me.invalidate_right(t + 1)
        else:
            b_tensor, centers, dw = split_backward_update(
                eff, psis, self.weights, noise, bond_dim,
                allowed=_bond_window(self.mps.info, t + 1,
                                     complement_of=eff.target),
                decomp_type=self.decomp_type,
                trunc_cutoff=self.trunc_cutoff, keep_out=spectra)
            t3 = time.time()
            tm.tdm += t3 - t2
            self.mps.tensors[t + 1] = b_tensor
            self.mps.tensors[t] = centers[0]
            self._center_tensors = centers
            self._center_pos = t
            self.me.update_right(t + 1)
            self.me.invalidate_left(t)
        if spectra:
            self.wfn_spectra.append(spectra[0])
        tm.tblk += time.time() - t3
        return energies, dw, nmv
