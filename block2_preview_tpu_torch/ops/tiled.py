"""Tiled sigma matvec — kernel K7 — and the port's copy of the reference's
tiled struct.

The copy: ``_pow2``, ``_TILE_CFG``, ``pick_tile``, ``_tile_grid`` and
:func:`tile_struct` (the reference's ``TiledExecutor._build_struct``,
block2_preview_tpu/ops/tiled.py:39-64 and :190-340), so the struct arrays
are the reference's field by field; :func:`pack_tiled` builds the
reference's tile pools (``_pack_tiled``, :66-83) with one gather on the
device, and :func:`tiled_matvec_plain` runs the reference's
``_tiled_matvec_impl`` (:86) on them group by group.  The reference cuts
every GEMM triple ``sigma[ok] += LW[m][lk] @ psi[pk] @ RW[m][rk].T`` of an
effective Hamiltonian into T x T tile tasks over tile-major pools:

  stage 1:  tmp[s1] += lp[la] @ pp[pa]
  stage 2:  sig[s2] += tmp[ta] @ rp[ra]^T

with ``pp = xp[psi_idx]`` (padding points at the zero slot ``size_p``) and
the flat sigma read back through ``sig_idx``; the task arrays are
``[G, B]`` groups, sentinels (``lzero``/``rzero`` zero tiles, tile ids
``nt1``/``nt2``) pad each group.  The tests hold these against the JAX
package; the port's matvec does not run them.

The port's matvec (:class:`TiledExecutor`, :func:`tiled_matvec`) runs the
same triples at their true shapes: one item a triple (eight scalars,
``exec_bucket.build_struct``), LW/RW as two flat pools
(``exec_bucket.pack_pool``), psi and sigma flat.  On CUDA tensors
:func:`tiled_matvec` launches kernel K7 (``csrc/tiled.cu``, the chain core
of K1 and K8, ``csrc/chain_mv.cuh``) in float32, float64, complex64 and
complex128 (the plain product, no conjugation, as the reference's
einsums) on the items sorted by sigma block and cut into chunks
(``exec_bucket.kernel_tables``), or raises; on CPU tensors it runs the
plain version over the same items and pools
(``exec_bucket.bucket_sigma_plain``).

:class:`TiledExecutor` is the device contract of the time evolution
(``dmrg/tdvp.py``) and of ``backend="torch_tiled"`` ground states:
``exec_bucket.BucketExecutor`` launching K7 and taking complex types —
host environments and LW/RW, pools packed and uploaded per center, the
matvec on the device, and ``solve_ground_state``, the port's device
Davidson around K7 (the reference's ``_tiled_dav``, :391).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .exec_bucket import BucketExecutor, chain_sigma, operator_mats


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length() if n > 0 else 1


# per tile size: (task chunk B, tmp pool tiles)
_TILE_CFG = {16: (8192, 16384), 32: (8192, 8192), 64: (4096, 4096),
             128: (4096, 2048)}


def pick_tile(dims: np.ndarray) -> int:
    """Choose tile size from the p90 of true block dims."""
    if len(dims) == 0:
        return 32
    p = float(np.percentile(dims, 90))
    if p <= 24:
        return 16
    if p <= 48:
        return 32
    if p <= 160:
        return 64
    return 128


# tile elements placed per gather of pack_tiled (bounds its int64 index
# temporaries to ~100 MB)
_PACK_CHUNK = 1 << 22


def _tile_grid(r: int, c: int, T: int) -> Tuple[int, int]:
    return -(-r // T), -(-c // T)


def pack_tiled(mats: List[np.ndarray], T: int, dtype, device
               ) -> Tuple[torch.Tensor, np.ndarray]:
    """Pack matrices tile-major on ``device``: returns (pool [cap, T, T],
    base[i]) — the reference's ``_pack_tiled`` (tiled.py:66), which padded
    and copied every matrix in a Python loop.  Here the blocks go up as one
    flat array and gathers on the device place every tile element (zero
    outside each matrix and in the capacity padding), in chunks of
    _PACK_CHUNK elements so the index temporaries stay small."""
    from ..runtime import torch_dtype
    n = len(mats)
    shp = np.asarray([m.shape for m in mats], dtype=np.int64).reshape(n, 2)
    nr, nc = -(-shp[:, 0] // T), -(-shp[:, 1] // T)
    bases = np.concatenate([[0], np.cumsum(nr * nc)]).astype(np.int64)
    ntot = int(bases[-1])
    cap = _pow2(ntot + 1)
    tdt = torch_dtype(dtype, complex_ok=True)
    pool = torch.zeros((cap, T, T), dtype=tdt, device=device)
    if ntot == 0:
        return pool, bases
    sizes = shp[:, 0] * shp[:, 1]
    flat = np.empty(int(sizes.sum()) + 1, dtype=dtype)
    # same_kind: a complex matrix into a real pool raises (no silent loss
    # of the imaginary part)
    np.concatenate([np.asarray(m).ravel() for m in mats], out=flat[:-1],
                   casting="same_kind")
    flat[-1] = 0                        # the zero every padding lane reads
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    mat = np.repeat(np.arange(n), nr * nc)
    o = np.arange(ntot) - bases[mat]
    dev = torch.device(device)
    fl = torch.as_tensor(flat, device=dev)

    def col(a):
        return torch.as_tensor(a, device=dev)[:, None, None]

    ar = torch.arange(T, device=dev)
    step = max(1, _PACK_CHUNK // (T * T))
    for a in range(0, ntot, step):
        sl = slice(a, min(a + step, ntot))
        m_, o_ = mat[sl], o[sl]
        row = col(o_ // nc[m_] * T) + ar[None, :, None]
        cc = col(o_ % nc[m_] * T) + ar[None, None, :]
        rows, cols = col(shp[m_, 0]), col(shp[m_, 1])
        src = torch.where((row < rows) & (cc < cols),
                          col(offs[m_]) + row * cols + cc, len(flat) - 1)
        pool[sl] = fl[src]
    return pool, bases


# ---------------------------------------------------------------------------
# the reference's tiled matvec (the copy) and kernel K7
# ---------------------------------------------------------------------------

def tiled_matvec_plain(xp, lp, rp, d: Dict, nt1: int, nt2: int, T: int):
    """Plain PyTorch version of the reference's ``_tiled_matvec_impl``
    group by group.  ``xp`` [size_p + 1] padded flat psi (zero last slot),
    ``lp``/``rp`` [cap, T, T] tile pools, ``d`` the tables of
    :func:`tile_tables`.  Returns sigma [size_p].

    Sentinel tasks (target tile nt1 / nt2) are skipped: they multiply the
    zero tiles lzero / rzero into slots the result never reads."""
    pp = xp[d["psi_idx"]].reshape(nt2, T, T)
    sig = xp.new_zeros((nt2 + 1, T, T))
    for la, pa, s1, ta, ra, s2 in zip(d["la"], d["pa"], d["s1"], d["ta"],
                                      d["ra"], d["s2"]):
        m1, m2 = s1 != nt1, s2 != nt2
        if not bool(m1.any()):
            continue
        s1 = s1[m1]
        tmp = xp.new_zeros((int(s1.max()) + 1, T, T))
        tmp.index_add_(0, s1, torch.bmm(lp[la[m1]], pp[pa[m1]]))
        sig.index_add_(0, s2[m2], torch.bmm(tmp[ta[m2]],
                                            rp[ra[m2]].transpose(1, 2)))
    return sig.reshape(-1)[d["sig_idx"]]


def tile_tables(struct: Dict, device) -> Dict:
    """The struct's tables :func:`tiled_matvec_plain` reads, on
    ``device``: psi_idx, sig_idx and the [G, B] task groups."""
    d = {k: torch.as_tensor(struct[k], device=device).long()
         for k in ("sig_idx", "la", "pa", "s1", "ta", "ra", "s2")}
    d["psi_idx"] = torch.as_tensor(struct["psi_idx"].reshape(-1),
                                   device=device).long()
    return d


def tiled_matvec(xp, lpool, rpool, d: Dict, size_p: int):
    """Sigma matvec (kernel K7): flat sigma [size_p] from the padded flat
    psi ``xp`` [size_p + 1] and the flat LW/RW pools, in any of the four
    types, on the device of ``xp``: ``d`` holds
    ``exec_bucket.kernel_tables`` there.  CPU tensors run
    ``exec_bucket.bucket_sigma_plain`` (``d`` from
    ``exec_bucket.plain_tables``)."""
    return chain_sigma(*TiledExecutor.KERNEL, xp, lpool, rpool, d, size_p)


def tile_struct(eff, T: int = None) -> Dict:
    """The reference's tiled struct of ``eff`` (``TiledExecutor.
    _build_struct``, tiled.py:190-340) at tile T (default
    :func:`pick_tile` of the block dims): tile bases of the LW/RW pools
    (``lbases``/``rbases``, in ``exec_bucket.operator_mats`` order), the
    flat <-> tiled maps ``psi_idx``/``sig_idx`` and the [G, B] task
    groups."""
    lw_ids, rw_ids, lw_mats, rw_mats = operator_mats(eff)
    lw_shapes = [m.shape for m in lw_mats]
    rw_shapes = [m.shape for m in rw_mats]
    if T is None:
        dims = []
        for s in lw_shapes + rw_shapes:
            dims += [s[0], s[1]]
        for k in eff.offsets:
            dims += list(eff.shapes[k])
        T = pick_tile(np.asarray(dims))
    B, nt1 = _TILE_CFG[T]

    lbases = np.zeros(len(lw_shapes) + 1, dtype=np.int64)
    for i, s in enumerate(lw_shapes):
        nr, nc = _tile_grid(s[0], s[1], T)
        lbases[i + 1] = lbases[i] + nr * nc
    rbases = np.zeros(len(rw_shapes) + 1, dtype=np.int64)
    for i, s in enumerate(rw_shapes):
        nr, nc = _tile_grid(s[0], s[1], T)
        rbases[i + 1] = rbases[i] + nr * nc

    # tiled layout of the flat psi/sigma vector
    vb: Dict = {}
    nv = 0
    for k in sorted(eff.offsets):
        r, c = eff.shapes[k]
        nr, nc = _tile_grid(r, c, T)
        vb[k] = (nv, nr, nc)
        nv += nr * nc
    nt2 = _pow2(nv + 1)

    # gather maps flat <-> tiled
    size_p = _pow2(eff.size + 1)
    psi_idx = np.full((nt2, T, T), size_p, dtype=np.int32)
    sig_idx = np.zeros(size_p, dtype=np.int64)
    for k in sorted(eff.offsets):
        off = eff.offsets[k]
        r, c = eff.shapes[k]
        base, nr, nc = vb[k]
        flat = off + np.arange(r * c, dtype=np.int64)
        fr, fc = np.divmod(np.arange(r * c), c)
        tidx = ((base + (fr // T) * nc + (fc // T)) * (T * T)
                + (fr % T) * T + (fc % T))
        sig_idx[flat] = tidx
        psi_flat = psi_idx.reshape(-1)
        psi_flat[tidx] = flat
    sig_idx[eff.size:] = (nt2 + 1) * T * T - 1   # pad -> last (zero) slot

    # tasks — vectorized expansion
    lzero = int(lbases[-1])
    rzero = int(rbases[-1])
    ntr = len(eff.triples)
    lid_a = np.empty(ntr, dtype=np.int64)
    rid_a = np.empty(ntr, dtype=np.int64)
    pb_a = np.empty(ntr, dtype=np.int64)
    ob_a = np.empty(ntr, dtype=np.int64)
    for i, (m, lk, pk, rk, ok) in enumerate(eff.triples):
        lid_a[i] = lw_ids[(m, lk)]
        rid_a[i] = rw_ids[(m, rk)]
        pb_a[i] = vb[pk][0]
        ob_a[i] = vb[ok][0]
    lsh = np.asarray(lw_shapes, dtype=np.int64)[lid_a] \
        if ntr else np.zeros((0, 2), dtype=np.int64)
    rsh = np.asarray(rw_shapes, dtype=np.int64)[rid_a] \
        if ntr else np.zeros((0, 2), dtype=np.int64)
    na_a = -(-lsh[:, 0] // T)
    nk_a = -(-lsh[:, 1] // T)
    np_a = -(-rsh[:, 0] // T)
    nn_a = -(-rsh[:, 1] // T)
    itmp = na_a * nn_a
    is1 = itmp * nk_a
    is2 = itmp * np_a
    if ntr and (itmp.max() > nt1 or is1.max() > B or is2.max() > B):
        raise ValueError(f"block too large for tile cfg T={T}")
    # greedy grouping (sequential, per item)
    grp = np.empty(ntr, dtype=np.int64)
    tb_a = np.empty(ntr, dtype=np.int64)       # tmp base within group
    o1_a = np.empty(ntr, dtype=np.int64)       # stage-1 offset in group
    o2_a = np.empty(ntr, dtype=np.int64)       # stage-2 offset in group
    g = t_used = u1 = u2 = 0
    for i in range(ntr):
        if (t_used + itmp[i] > nt1 or u1 + is1[i] > B
                or u2 + is2[i] > B):
            g += 1
            t_used = u1 = u2 = 0
        grp[i] = g
        tb_a[i] = t_used
        o1_a[i] = u1
        o2_a[i] = u2
        t_used += itmp[i]
        u1 += is1[i]
        u2 += is2[i]
    ng = (g + 1) if ntr else 0
    G = _pow2(max(ng, 1))
    la = np.full((G, B), lzero, dtype=np.int32)
    pa = np.full((G, B), nt2, dtype=np.int32)
    s1 = np.full((G, B), nt1, dtype=np.int32)
    ta = np.full((G, B), nt1, dtype=np.int32)
    ra = np.full((G, B), rzero, dtype=np.int32)
    s2 = np.full((G, B), nt2, dtype=np.int32)
    if ntr:
        # stage 1: per item, tasks ordered (ai, ni, ki)
        tot1 = int(is1.sum())
        item1 = np.repeat(np.arange(ntr), is1)
        cum1 = np.concatenate([[0], np.cumsum(is1)[:-1]])
        o = np.arange(tot1) - np.repeat(cum1, is1)
        nk1 = nk_a[item1]
        nn1 = nn_a[item1]
        ai = o // (nn1 * nk1)
        ni = (o // nk1) % nn1
        ki = o % nk1
        pos = np.repeat(o1_a, is1) + o
        gi = grp[item1]
        la[gi, pos] = (lbases[lid_a] + 0)[item1] + ai * nk1 + ki
        pa[gi, pos] = pb_a[item1] + ki * nn1 + ni
        s1[gi, pos] = np.repeat(tb_a, is1) + ai * nn1 + ni
        # stage 2: per item, tasks ordered (ai, ni, pi), then sorted
        # per group by target sigma tile (segment-sum requirement)
        tot2 = int(is2.sum())
        item2 = np.repeat(np.arange(ntr), is2)
        cum2 = np.concatenate([[0], np.cumsum(is2)[:-1]])
        o = np.arange(tot2) - np.repeat(cum2, is2)
        nn2 = nn_a[item2]
        npp = np_a[item2]
        ai = o // (nn2 * npp)
        ni = (o // npp) % nn2
        pi = o % npp
        v_s2 = ob_a[item2] + ai * npp + pi
        v_ta = np.repeat(tb_a, is2) + ai * nn2 + ni
        v_ra = rbases[rid_a][item2] + pi * nn2 + ni
        gi2 = grp[item2]
        order = np.lexsort((v_ra, v_ta, v_s2, gi2))
        gsz = np.bincount(gi2, minlength=ng)
        gstart = np.concatenate([[0], np.cumsum(gsz)[:-1]])
        pos2 = np.arange(tot2) - np.repeat(gstart, gsz)
        s2[gi2[order], pos2] = v_s2[order]
        ta[gi2[order], pos2] = v_ta[order]
        ra[gi2[order], pos2] = v_ra[order]

    return {
        "T": T, "B": B, "nt1": nt1, "nt2": nt2,
        "size_p": size_p,
        "lbases": lbases, "rbases": rbases,
        "psi_idx": psi_idx,
        "sig_idx": np.minimum(sig_idx, (nt2 + 1) * T * T - 1),
        "la": la, "pa": pa, "s1": s1, "ta": ta, "ra": ra, "s2": s2,
    }


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------

class TiledExecutor(BucketExecutor):
    """Sigma-vector executor of one effective Hamiltonian on the tiled
    engine: ``exec_bucket.BucketExecutor`` (items, flat pools, chain
    tables, device Davidson) launching kernel K7, in float32, float64,
    complex64 or complex128 — the executor of the time evolution and of
    ``backend="torch_tiled"``."""

    KERNEL = ("K7_tiled", "b2t_tiled")
    COMPLEX = True
