"""Reference host objects -> the port's structures.

The JAX package's plan builders and the port's copies produce the same
tables; these helpers take an object built by the reference — an MPO, an
MPS, a plan — and rebuild it as the port's class from its numpy arrays
and plain attributes, so the two packages can be fed the same state and
one plan can run through a JAX kernel and the matching port kernel side
by side.  Only attributes are read: nothing here imports the reference
package or JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.blocks import MPSTensor
from .core.state_info import StateInfo
from .core.symmetry import SymmetryGroup
from .dmrg.mpo import MPO
from .dmrg.mps import MPS, MPSInfo
from .ops.blocking_plan import BlockingPlan
from .ops.mixv3 import MixPlanV3
from .ops.mixv4 import MixPlanV4
from .ops.resident import MixPlan, SlabMatvec
from .ops.stacked import StackedMeta, StackedPlan, stacked_plan as _stacked
from .ops.tiled_blocking import TiledBlockingPlan
from .ops.tilev2 import MatvecV2
from .runtime import torch_dtype


def _qn(q):
    return tuple(int(x) for x in q)


def group(ref_group) -> SymmetryGroup:
    """Port SymmetryGroup with the reference group's factors."""
    return SymmetryGroup(tuple(ref_group.kinds), tuple(ref_group.names),
                         fermion_index=int(ref_group.fermion_index))


def mpo(ref_mpo) -> MPO:
    """Port MPO with copies of the reference MPO's site tensors."""
    return MPO(group=group(ref_mpo.group), n_sites=int(ref_mpo.n_sites),
               site_quanta=[[_qn(q) for q in qs]
                            for qs in ref_mpo.site_quanta],
               bond_dqs=[[_qn(q) for q in b] for b in ref_mpo.bond_dqs],
               tensors=[{(int(i), int(o)): np.array(w)
                         for (i, o), w in ent.items()}
                        for ent in ref_mpo.tensors],
               const_e=float(ref_mpo.const_e))


def mps(ref_mps) -> MPS:
    """Port MPS with copies of the reference MPS's site tensors and bond
    spaces."""
    ri = ref_mps.info
    g = group(ri.group)
    info = MPSInfo(g, [[_qn(q) for q in qs] for qs in ri.site_quanta],
                   _qn(ri.target), int(ri.bond_dim))
    info.bonds = [StateInfo(g, {_qn(q): int(n) for q, n in b.items()})
                  for b in ri.bonds]
    tensors = [MPSTensor(g, {tuple(_qn(q) for q in k): np.array(b)
                             for k, b in t.blocks.items()})
               for t in ref_mps.tensors]
    return MPS(info, tensors, center=int(ref_mps.center))


def stacked_meta(ref_meta) -> StackedMeta:
    """Port StackedMeta with the reference meta's groups and sectors."""
    return StackedMeta(ref_meta.groups, ref_meta.sectors, ref_meta.total)


def mix_plan_v4(ref_plan) -> MixPlanV4:
    """Port MixPlanV4 from a reference MixPlanV4 (host fields only; the
    reference's packed upload is not carried)."""
    p = MixPlanV4()
    for k in MixPlanV4.__slots__:
        if k != "_dev":     # the port's own cache
            setattr(p, k, getattr(ref_plan, k))
    p.meta_out = stacked_meta(ref_plan.meta_out)
    p._dev = {}
    return p


def mix_plan_v3(ref_plan) -> MixPlanV3:
    """Port MixPlanV3 from a reference MixPlanV3 (host fields only; its
    device-struct token is not carried)."""
    p = MixPlanV3()
    for k in MixPlanV3.__slots__:
        if k != "_dev":     # the port's own cache
            setattr(p, k, getattr(ref_plan, k))
    p.meta_out = stacked_meta(ref_plan.meta_out)
    p._dev = {}
    return p


def mix_plan_v2(ref_plan) -> MixPlan:
    """Port v2 MixPlan from a reference MixPlan."""
    p = MixPlan()
    for k in MixPlan.__slots__:
        if k != "_dev":     # the port's own cache
            setattr(p, k, getattr(ref_plan, k))
    p.meta_out = stacked_meta(ref_plan.meta_out)
    p._dev = {}
    return p


def slab_matvec(ref_ex, dtype=np.float64) -> SlabMatvec:
    """Port SlabMatvec around a reference SlabMatvec's host struct."""
    ex = SlabMatvec.__new__(SlabMatvec)
    ex.dtype = np.dtype(dtype)
    ex.space, ex.bra_space = ref_ex.space, ref_ex.bra_space
    ex.size = ref_ex.size
    ex.struct = dict(ref_ex.struct)
    ex._dev = {}
    return ex


def matvec_v2(ref_ex, dtype=np.float64) -> MatvecV2:
    """Port MatvecV2 around a reference MatvecV2's host struct."""
    ex = MatvecV2.__new__(MatvecV2)
    ex.dtype = dtype
    ex.space, ex.bra_space = ref_ex.space, ref_ex.bra_space
    ex.size, ex.out_size = ref_ex.size, ref_ex.out_size
    ex.struct = {k: v for k, v in ref_ex.struct.items()
                 if not k.startswith("_")}
    ex._dev = None
    ex._parts = {}
    return ex


def tiled_struct(ref_ex) -> dict:
    """The host struct of a reference TiledExecutor as numpy arrays (its
    device-cache token dropped)."""
    return {k: (np.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in ref_ex.struct.items() if not k.startswith("_")}


def bucket_struct(ref_struct) -> dict:
    """A reference FusedPlanExecutor's bucket struct (what its
    ``_build_struct`` returns and its structure cache holds; the executor
    keeps only the device arrays) as numpy: ``buckets`` [{ga, gr, pidx}],
    ``perm``, ``seg_ids``, ``mask``."""
    return {"buckets": [{k: np.asarray(v) for k, v in b.items()}
                        for b in ref_struct["buckets"]],
            **{k: np.asarray(ref_struct[k])
               for k in ("perm", "seg_ids", "mask")}}


def blocking_plan(ref_plan) -> BlockingPlan:
    """Port BlockingPlan with the fields of a reference BlockingPlan (its
    device struct cache is not carried)."""
    p = BlockingPlan()
    for k in BlockingPlan.__slots__:
        setattr(p, k, getattr(ref_plan, k))
    return p


def stacked_plan(ref_plan) -> StackedPlan:
    """Port StackedPlan from a reference StackedPlan: its buckets' items
    and mix chunks with the padding taken out (padded items have
    dl = dk = dx = dy = 0 and close their chunk; padded mix rows have
    tgt = (0, 0, 0)), in the reference's bucket order; a row's ``src`` =
    c S + j becomes (item, symbol)."""
    cols = ("eoff", "boff", "koff", "dl", "dx", "dk", "dy")
    items, rc, rj, coef, tgt = [], [], [], [], []
    base = 0
    for bk in ref_plan.buckets:
        f = np.stack([np.asarray(bk[k], np.int64) for k in cols], axis=1)
        live = f[f[:, 3] > 0]
        for src, cf, tg in bk["mix"]:
            src = np.asarray(src, np.int64)
            tg = np.asarray(tg, np.int64).reshape(-1, 3)
            keep = tg.any(axis=1)
            rc.append(base + src[keep] // bk["S"])
            rj.append(src[keep] % bk["S"])
            coef.append(np.asarray(cf)[keep])
            tgt.append(tg[keep])
        items.append(live)
        base += len(live)
    return _stacked(np.concatenate(items), np.concatenate(rc),
                    np.concatenate(rj), np.concatenate(coef),
                    np.concatenate(tgt), stacked_meta(ref_plan.meta_out),
                    ref_plan.direction == "left", ref_plan.bra_sizes,
                    ref_plan.ket_sizes)


def tiled_blocking_plan(ref_plan) -> TiledBlockingPlan:
    """Port TiledBlockingPlan with the fields of a reference
    TiledBlockingPlan (no ``flops``; its device cache is not carried)."""
    p = TiledBlockingPlan()
    for k in ("T", "nt1", "ntp", "ncap", "left", "s1", "s2", "s3", "coef",
              "bra_pool", "ket_pool", "_src"):
        setattr(p, k, getattr(ref_plan, k))
    p.meta_out = stacked_meta(ref_plan.meta_out)
    p.flops = None
    p._dev = {}
    return p


def diag_struct(ref_ds) -> dict:
    """Port diag struct from the reference's build_diag_struct output."""
    return {k: v for k, v in ref_ds.items() if not k.startswith("_")}


def slab_pool(pool, device, dtype=np.float64) -> torch.Tensor:
    """A host (numpy) slab pool as a device tensor in the working dtype."""
    return torch.tensor(np.asarray(pool), dtype=torch_dtype(dtype),
                        device=device)
