"""The port's copied host plan builders (block2_preview_tpu_torch.ops)
give arrays equal to the reference builders' on the same state: stacked
pools, mix v3/v4 plans, the MatvecV2 struct and the diag struct, at an
edge and a mid-chain site, left and right.  The port's side is built
from its own classes: the reference MPO and MPS go through the
``interop`` converters and the port's host environments.

Also holds the Hubbard-L8 helpers the other tests/test_torch_*.py files
import (Hamiltonians are built in code, not read from decks)."""

import numpy as np
import pytest
import torch

from block2_preview_tpu.core.fcidump import FCIDUMP
from block2_preview_tpu.driver.core import DMRGDriver, SymmetryTypes
from block2_preview_tpu.dmrg.effective import EffectiveHamiltonian2
from block2_preview_tpu.dmrg.environment import MovingEnvironment
from block2_preview_tpu.dmrg.sweep import DMRG
from block2_preview_tpu.ops import mixv3 as ref_mixv3
from block2_preview_tpu.ops import mixv4 as ref_mixv4
from block2_preview_tpu.ops import resident as ref_resident
from block2_preview_tpu.ops import stacked as ref_stacked
from block2_preview_tpu.ops import tilev2 as ref_tilev2

from block2_preview_tpu_torch import interop
from block2_preview_tpu_torch.dmrg.effective import (
    EffectiveHamiltonian2 as PortEff)
from block2_preview_tpu_torch.dmrg.environment import (
    MovingEnvironment as PortME)
from block2_preview_tpu_torch.ops import mixv3, mixv4, resident, stacked
from block2_preview_tpu_torch.ops import tilev2

L8 = 8
SITES = (0, L8 // 2 - 1)

# Every tests/test_torch_*.py file imports this module.  The suite runs in
# parallel workers that share the cores; torch's spinning intra-op pool
# then slows the twins' many small CPU ops a hundredfold, so one thread.
torch.set_num_threads(1)


def hubbard_driver(L=L8):
    fd = FCIDUMP.hubbard(L, u=2, t=1)
    drv = DMRGDriver(symm_type=SymmetryTypes.SZ)
    drv.initialize_system(n_sites=L, n_elec=L, spin=0)
    mpo = drv.get_qc_mpo(h1e=fd.h1e, g2e=fd.g2e, ecore=fd.const_e)
    return drv, mpo


def hubbard_system(D=60, n_sweeps=2):
    """Hubbard-L8 MPO and an MPS after a few host sweeps."""
    drv, mpo = hubbard_driver()
    mps = drv.get_random_mps(D, seed=1234)
    DMRG(mpo, mps, iprint=0).solve([D] * n_sweeps, [1e-4] * n_sweeps,
                                   [1e-8], n_sweeps=n_sweeps, tol=0)
    return mpo, mps


def _mix_args(mpo, eff, t):
    """Mix-plan keyword and positional arguments of center t."""
    g = mpo.group
    tk = eff.target
    kw = {
            "lw": dict(bond_is_first=True, join_on_input=True, group=g,
                       out_bond_dqs=mpo.bond_dqs[t + 1],
                       active={q for (q, _) in eff.bra_space.keys},
                       fused_ket=eff.ket_space.fl,
                       active_ket={q for (q, _) in eff.ket_space.keys}),
            "rw": dict(bond_is_first=False, join_on_input=False, group=g,
                       out_bond_dqs=mpo.bond_dqs[t + 1], comp_target=tk,
                       active={q for (_, q) in eff.bra_space.keys},
                       fused_ket=eff.ket_space.fr, comp_target_ket=tk,
                       active_ket={q for (_, q) in eff.ket_space.keys})}
    pos = {"lw": (mpo.tensors[t], mpo.site_quanta[t], eff.bra_space.fl),
           "rw": (mpo.tensors[t + 1], mpo.site_quanta[t + 1],
                  eff.bra_space.fr)}
    return kw, pos


class Site:
    """Host environments + plan-builder arguments of the two-site center
    t, on both sides: the reference's (``eff``, ``mpo``; assembled host
    LW/RW on eff for host oracles) and the port's (``peff``, ``pmpo``,
    ``pmps``, from the converted MPO/MPS and the port's host blocking)."""

    def __init__(self, mpo, mps, t):
        me = MovingEnvironment(mpo, mps)
        me.init_environments()
        for s in range(t):
            me.update_left(s)
        self.t = t
        self.mpo = mpo
        self.eff = eff = EffectiveHamiltonian2(me, t)
        self.env = {"lw": me.left_envs[t], "rw": me.right_envs[t + 2]}
        self.dqs = {"lw": mpo.bond_dqs[t], "rw": mpo.bond_dqs[t + 2]}
        self.kw, self.pos = _mix_args(mpo, eff, t)
        self.pmpo, self.pmps = interop.mpo(mpo), interop.mps(mps)
        pme = PortME(self.pmpo, self.pmps)
        pme.init_environments()
        for s in range(t):
            pme.update_left(s)
        self.peff = PortEff(pme, t, assemble=False)
        self.penv = {"lw": pme.left_envs[t], "rw": pme.right_envs[t + 2]}
        self.pkw, self.ppos = _mix_args(self.pmpo, self.peff, t)

    def ref_pool(self, side, dtype=np.float64):
        """Reference meta + padded pool, as MovingEnvironment._ensure_stk
        ships it (zero sentinel last)."""
        meta = ref_stacked.meta_from_env(self.env[side], self.dqs[side])
        pool = meta.pack(self.env[side], dtype=dtype)
        pp = np.zeros(ref_stacked._cap_class(len(pool) + 1), dtype=dtype)
        pp[:len(pool)] = pool
        return meta, pp

    def ref_plans(self, side):
        meta, pool = self.ref_pool(side)
        p3 = ref_mixv3.build_mix_plan_v3(meta, *self.pos[side],
                                         **self.kw[side])
        return p3, ref_mixv4.plan_v4(p3), pool

    def port_plans(self, side):
        meta, pool = stacked.env_pool(self.penv[side], self.dqs[side],
                                      np.float64)
        p3 = mixv3.build_mix_plan_v3(meta, *self.ppos[side],
                                     **self.pkw[side])
        return p3, mixv4.plan_v4(p3), pool

    def ref_matvec(self, pl, pr, **kw):
        eff = self.eff
        return ref_tilev2.MatvecV2(eff.ket_space, pl.meta_out, pr.meta_out,
                                   self.mpo.group, eff.target,
                                   dtype=np.float64,
                                   bra_space=eff.bra_space, **kw)


@pytest.fixture(scope="module")
def system():
    return hubbard_system()


def _eq(a, b, what):
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _eq(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _eq(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert np.array_equal(a, b), what
    else:
        assert a == b, what


@pytest.mark.parametrize("t", SITES)
@pytest.mark.parametrize("side", ["lw", "rw"])
def test_stacked_pool_layout(system, t, side):
    site = Site(*system, t)
    ref_meta, ref_pool = site.ref_pool(side)
    meta, pool = stacked.env_pool(site.penv[side], site.dqs[side],
                                  np.float64)
    assert meta.signature() == ref_meta.signature()
    assert meta.total == ref_meta.total
    _eq(pool, ref_pool, "pool")
    assert pool[-1] == 0.0 and len(pool) > meta.total


@pytest.mark.parametrize("side", ["lw", "rw"])
def test_stacked_unpack_matches_reference(system, side):
    """StackedMeta.unpack of a packed pool gives the reference's blocks,
    which are the environment's own non-zero blocks."""
    site = Site(*system, SITES[1])
    ref_meta, pool = site.ref_pool(side)
    meta, _ = stacked.env_pool(site.penv[side], site.dqs[side], np.float64)
    g = site.pmpo.group
    got = meta.unpack(pool, g, site.dqs[side])
    ref = ref_meta.unpack(pool, site.mpo.group, site.dqs[side])
    assert set(got) == set(ref) and got
    for s, bm in ref.items():
        assert got[s].dq == bm.dq
        _eq(got[s].blocks, bm.blocks, f"sym {s}")
        for key, mat in bm.blocks.items():
            assert np.array_equal(mat, site.env[side][s].blocks[key])


@pytest.mark.parametrize("t", SITES)
@pytest.mark.parametrize("side", ["lw", "rw"])
def test_mix_plans_equal(system, t, side):
    site = Site(*system, t)
    r3, r4, _ = site.ref_plans(side)
    p3, p4, _ = site.port_plans(side)
    assert p3.meta_out.signature() == r3.meta_out.signature()
    for k in ("ncap_out", "out_total", "iscpx", "dims_hint", "n_launch",
              "gemms", "tables", "winflat"):
        _eq(getattr(p3, k), getattr(r3, k), f"v3.{k}")
    assert p4.meta_out.signature() == r4.meta_out.signature()
    for k in mixv4.MixPlanV4.__slots__:
        if k != "meta_out":
            _eq(getattr(p4, k), getattr(r4, k), f"v4.{k}")


@pytest.mark.parametrize("t", SITES)
def test_matvec_and_diag_structs_equal(system, t):
    site = Site(*system, t)
    rl, rr = site.ref_plans("lw")[1], site.ref_plans("rw")[1]
    pl, pr = site.port_plans("lw")[1], site.port_plans("rw")[1]
    ref = site.ref_matvec(rl, rr)
    eff = site.peff
    ex = tilev2.MatvecV2(eff.ket_space, pl.meta_out, pr.meta_out,
                         site.pmpo.group, eff.target, dtype=np.float64,
                         bra_space=eff.bra_space)
    _eq(ex.struct, {k: v for k, v in ref.struct.items()
                    if not k.startswith("_")}, "struct")
    s = ex.struct
    ds = resident.build_diag_struct(eff.ket_space, pl.meta_out, pr.meta_out,
                                    s["T"], s["nt2"], s["sig_idx"])
    rds = ref_resident.build_diag_struct(site.eff.ket_space, rl.meta_out,
                                         rr.meta_out, s["T"], s["nt2"],
                                         s["sig_idx"])
    _eq(ds, rds, "diag")
