"""Bucketed sigma-vector executor — kernel K8.

Counterpart of block2_preview_tpu/ops/exec_jax.py (``FusedPlanExecutor``,
``_fused_sigma`` :136-150, ``_dav_jit`` :347), the sigma matvec of the
reference's ``jax`` and ``jax_device`` backends.  Every triple
``sigma[ok] += LW[m][lk] @ psi[pk] @ RW[m][rk].T`` of an effective
Hamiltonian is one item; the reference groups the items into buckets of
``_round_dim``-padded shapes (a, k, n, p), sorted, with the batch padded by
``_round_batch``.

Host side: :func:`build_struct` makes that bucketing (the reference's
``_build_struct`` :226-314, copied in its grouping and order) but keeps
each item as eight scalars — LW offset, a, k, psi offset, n, RW offset, p,
sigma offset — instead of element-wise gather tables;
:func:`reference_struct` expands them into the reference's fields
(``buckets[*].ga/gr/pidx``, ``perm``, ``seg_ids``, ``mask``), which the
tests hold equal to the JAX package's.  The LW and RW matrices go to the
device once per executor as two flat pools (:func:`pack_pool`); the
reference's padded stacks ``A = lpool[ga]``, ``R = rpool[gr]`` are not
formed, and no element-wise index tensor is made on the device.

Device side: :func:`bucket_sigma` is the wrapper of kernel K8
(``csrc/bucket.cu``, the chain core shared with K1, on the items sorted
by sigma block and cut into chunks, :func:`kernel_tables`, built once
per struct by :func:`chain_tables`) in float32 and float64.  On CPU
tensors it runs :func:`bucket_sigma_plain`, the plain PyTorch version of
the reference's ``_fused_sigma_impl`` bucket by bucket; on CUDA tensors
it launches K8 or raises.  :func:`chain_sigma` is that launch for either
kernel on the core: K8, or K7 of the tiled engine (``ops/tiled.py``),
which reads the same items, tables and flat pools in complex types too.
The bucketed executor takes real types only: a complex effective
Hamiltonian raises and names ``torch_tiled``, the backend that carries
complex (the reference casts the bucketed matvec to float64,
exec_jax.py:328, which drops an imaginary part).

:class:`BucketExecutor` holds one center: ``matvec`` (host vectors),
``matvec_device`` (padded device vectors), ``solve_ground_state`` (the
port's device Davidson around K8, the reference's ``_dav_jit``), ``pad``
and ``free``; ``ops/tiled.TiledExecutor`` is the same class launching
K7 and taking complex types.

:class:`PlanExecutor` is the reference's older padded-bucket executor
(exec_jax.py:75-128, whose matvec is ``_execute``/``_bucket_exec``): its
``device_buckets`` are the reference's zero-padded stacks (A, R, pidx,
oidx), field-equal, as views of two flat device pools
(``runtime.unpack_views``).  Its matvec is kernel K18
(``csrc/plan_exec.cu``; :func:`plan_exec`): the chain core's strided
instance over the true items only, each read in place from the padded
stacks (:func:`plan_chain_tables`), or :func:`plan_exec_plain`, the
stacks run as they are, on CPU tensors.  :meth:`PlanExecutor.rank_part`
and :func:`plan_exec_part` (kernel K22, ``csrc/plan_exec_shard.cu``: K18's
instance over the true items of one rank's batch slices of the buckets)
run one rank's share, for ``parallel/shard.py::ShardedPlanExecutor``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import _kernels, chain_mv

VEC_PAD = 2048      # flat psi/sigma vectors padded to multiples of this

# elements of one padded gather of the plain versions (bounds their int64
# index temporaries)
_PLAIN_CHUNK = 1 << 24


def _round_dim(d: int) -> int:
    """Pad block dims into a small set of bucket sizes."""
    if d <= 1:
        return 1
    if d <= 16:
        return 1 << (d - 1).bit_length()
    return ((d + 15) // 16) * 16


def _round_batch(b: int) -> int:
    """Pad batch counts to powers of two (the reference's jit signatures;
    here only :func:`reference_struct` uses it)."""
    return 1 << max(b - 1, 0).bit_length() if b > 0 else 1


def padded_size(size: int) -> int:
    return ((size + VEC_PAD) // VEC_PAD) * VEC_PAD


# item columns (K18's items add _LDL, _LDR: the row lengths of L and R)
_LOFF, _A, _K, _POFF, _N, _ROFF, _P, _OOFF, _LDL, _LDR = range(10)


def build_struct(eff, lw_ids, rw_ids, lw_shapes, rw_shapes) -> Dict:
    """The bucketed structure of ``eff``: buckets keyed (a, k, n, p) =
    _round_dim of the true dims, sorted, items in triple order — the
    reference's grouping — with each item as the eight scalars of
    ``items`` [N, 8] (int64).  ``bounds`` [nb + 1] delimit the buckets'
    items.  A triple whose psi or sigma block does not have the LW/RW
    dims raises."""
    size_p = padded_size(eff.size)
    lsz = np.asarray([s[0] * s[1] for s in lw_shapes] or [0], np.int64)
    loffs = np.concatenate([[0], np.cumsum(lsz)])
    rsz = np.asarray([s[0] * s[1] for s in rw_shapes] or [0], np.int64)
    roffs = np.concatenate([[0], np.cumsum(rsz)])
    buckets: Dict[Tuple[int, int, int, int], List] = {}
    for (m, lk, pk, rk, ok) in eff.triples:
        li, ri = lw_ids[(m, lk)], rw_ids[(m, rk)]
        a0, k0 = lw_shapes[li]
        p0, n0 = rw_shapes[ri]
        if tuple(eff.shapes[pk]) != (k0, n0) or \
                tuple(eff.shapes[ok]) != (a0, p0):
            raise ValueError(f"triple {(m, lk, pk, rk, ok)}: psi block "
                             f"{eff.shapes[pk]} / sigma block "
                             f"{eff.shapes[ok]} do not match LW {(a0, k0)}"
                             f" and RW {(p0, n0)}")
        key = (_round_dim(a0), _round_dim(k0), _round_dim(n0),
               _round_dim(p0))
        buckets.setdefault(key, []).append(
            (loffs[li], a0, k0, eff.offsets[pk], n0, roffs[ri], p0,
             eff.offsets[ok]))
    keys = sorted(buckets)
    items = np.asarray([it for key in keys for it in buckets[key]],
                       dtype=np.int64).reshape(-1, 8)
    bounds = np.concatenate([[0], np.cumsum([len(buckets[k])
                                             for k in keys])])
    return {"size": eff.size, "size_p": size_p, "keys": keys,
            "bounds": bounds.astype(np.int64), "items": items,
            "nl": int(loffs[-1]), "nr": int(roffs[-1])}


def reference_struct(struct: Dict) -> Dict:
    """The reference's struct (exec_jax.py:226-314) from the compact one:
    per bucket the padded gather tables ``ga`` [B, a, k], ``gr`` [B, p, n]
    (int64, into the LW/RW pools, sentinel their end) and ``pidx``
    [B, k, n] (int32, into the padded psi, sentinel size_p); the stable
    sort ``perm`` of the flat sigma targets, ``seg_ids`` and ``mask``."""
    size_p = struct["size_p"]
    bnd = struct["bounds"]

    def grid(off, rows, cols, R, C, sent, dt):
        r = np.arange(R)[None, :, None]
        c = np.arange(C)[None, None, :]
        rt, ct = rows[:, None, None], cols[:, None, None]
        return np.where((r < rt) & (c < ct), off[:, None, None] + r * ct + c,
                        sent).astype(dt)

    buckets, targets = [], []
    for i, (a, k, n, p) in enumerate(struct["keys"]):
        f = struct["items"][bnd[i]:bnd[i + 1]]
        B = _round_batch(len(f))
        f = np.concatenate([f, np.zeros((B - len(f), 8), np.int64)])
        a0, k0, n0, p0 = f[:, _A], f[:, _K], f[:, _N], f[:, _P]
        buckets.append({
            "ga": grid(f[:, _LOFF], a0, k0, a, k, struct["nl"], np.int64),
            "gr": grid(f[:, _ROFF], p0, n0, p, n, struct["nr"], np.int64),
            "pidx": grid(f[:, _POFF], k0, n0, k, n, size_p, np.int32)})
        targets.append(grid(f[:, _OOFF], a0, p0, a, p, size_p,
                            np.int32).reshape(-1))
    targets = np.concatenate(targets) if targets else np.zeros(0, np.int32)
    perm = np.argsort(targets, kind="stable").astype(np.int32)
    mask = np.zeros(size_p + 1, dtype=np.float64)
    mask[:struct["size"]] = 1.0
    return {"buckets": buckets, "perm": perm, "seg_ids": targets[perm],
            "mask": mask}


def operator_mats(eff) -> Tuple[Dict, Dict, List, List]:
    """The LW and RW matrices of ``eff`` in pool order (symbol, then key,
    sorted): (lw_ids, rw_ids, lw_mats, rw_mats), the ids mapping (m, key)
    to a matrix's place."""
    ids: List[Dict] = [{}, {}]
    mats: List[List] = [[], []]
    for i, ops in enumerate((eff.LW, eff.RW)):
        for m, d in sorted(ops.items()):
            for k2, mat in sorted(d.items()):
                ids[i][(m, k2)] = len(mats[i])
                mats[i].append(mat)
    return ids[0], ids[1], mats[0], mats[1]


def cached_struct(eff, lw_ids, rw_ids, lw_mats, rw_mats, cache, cache_key):
    """:func:`build_struct` of ``eff``, looked up in ``cache`` under
    ``cache_key`` first: a hit needs the same signature of the shapes (the
    reference keys its bucket structs on ``(type(eff).__name__, eff.t)``,
    sweep.py:698-702, and checks the shapes on every hit)."""
    sig = None
    if cache is not None and cache_key is not None:
        sig = hash((eff.size, tuple(sorted(eff.shapes.items())),
                    tuple(eff.triples), tuple(m.shape for m in lw_mats),
                    tuple(m.shape for m in rw_mats)))
        ent = cache.get(cache_key)
        if ent is not None and ent[0] == sig:
            return ent[1]
    struct = build_struct(eff, lw_ids, rw_ids, [m.shape for m in lw_mats],
                          [m.shape for m in rw_mats])
    if sig is not None:
        cache[cache_key] = (sig, struct)
    return struct


def pack_pool(mats: List[np.ndarray], dtype, device) -> torch.Tensor:
    """The matrices raveled one after another, plus one zero, as one flat
    tensor on ``device`` (real or complex ``dtype``).  A complex matrix
    into a real pool raises."""
    from ..runtime import torch_dtype
    tdt = torch_dtype(dtype, complex_ok=True)
    flat = np.empty(sum(m.size for m in mats) + 1, dtype=dtype)
    if mats:
        np.concatenate([np.asarray(m).ravel() for m in mats], out=flat[:-1],
                       casting="same_kind")
    flat[-1] = 0
    return torch.as_tensor(flat, dtype=tdt, device=device)


def _int32(a: np.ndarray, what: str) -> np.ndarray:
    if a.size and (a.max() >= 2 ** 31 or a.min() < 0):
        raise ValueError(f"{what} does not fit int32")
    return np.ascontiguousarray(a, dtype=np.int32)


def plan_chain_tables(items: np.ndarray, cap=None) -> Dict:
    """K18's chain-core tables from PlanExecutor's true items ``items``
    [N, 10] (int64: the offset of the item's A block in the value pool,
    a, k, the psi offset, n, the offset of its R block, p, the sigma
    offset, and the row lengths of A and R in their padded stacks): the
    items sorted by sigma block (stable, as K8's :func:`chain_tables`) as
    int32 ``items``, their chunks (``ops/chain_mv.py``: ``ent``, ``ck``,
    cut at the FLOP band ``cap``, by default the items' own), the
    entries' ``flops`` and the build ``seconds``.  The core addresses the
    pools with int32 offsets: an A or R block that ends past 2^31 elements
    of the value pool, or a psi or sigma block past 2^31 elements, raises
    (no silent widening)."""
    t0 = time.perf_counter()
    it = np.asarray(items, np.int64).reshape(-1, 10)
    ends = {"an A block of the value pool": it[:, _LOFF] + (it[:, _A] - 1)
            * it[:, _LDL] + it[:, _K],
            "an R block of the value pool": it[:, _ROFF] + (it[:, _P] - 1)
            * it[:, _LDR] + it[:, _N],
            "a psi block": it[:, _POFF] + it[:, _K] * it[:, _N],
            "a sigma block": it[:, _OOFF] + it[:, _A] * it[:, _P]}
    for what, end in ends.items():
        if end.size and int(end.max()) > 2 ** 31 - 1:
            raise ValueError(f"K18: {what} ends at element {int(end.max())}"
                             ", past the int32 offsets of its chain items")
    it = it[np.argsort(it[:, _OOFF], kind="stable")]
    tab = chain_mv.chunk_tables(it[:, :_LDL], cap)
    tab["items"] = _int32(it, "a K18 chain item")
    tab["seconds"] = time.perf_counter() - t0
    return tab


# ---------------------------------------------------------------------------
# kernel K8 and its plain twin
# ---------------------------------------------------------------------------

def _grid(off, rows, cols, R: int, C: int, sent: int):
    """Flat indices of padded (R x C) blocks at ``off`` with true dims
    (rows, cols) ([n, 1, 1] tensors); padding points at ``sent``."""
    r = torch.arange(R, device=off.device)[None, :, None]
    c = torch.arange(C, device=off.device)[None, None, :]
    return torch.where((r < rows) & (c < cols), off + r * cols + c, sent)


def bucket_sigma_plain(xp, lpool, rpool, d: Dict, size_p: int):
    """Plain PyTorch version of K8: the reference's ``_fused_sigma_impl``
    bucket by bucket — padded gathers from the pools, one batched einsum,
    a scatter-add of the true elements into sigma.  ``d`` from
    :func:`plain_tables`.  Returns sigma [size_p]."""
    sig = xp.new_zeros(size_p + 1)
    sent_l, sent_r = lpool.shape[0] - 1, rpool.shape[0] - 1
    items = d["items"]
    for lo, hi, (a, k, n, p) in d["buckets"]:
        step = max(1, _PLAIN_CHUNK // max(a * k, k * n, p * n, a * p))
        for s in range(lo, hi, step):
            f = items[s:min(s + step, hi), :, None, None]
            a0, k0, n0, p0 = f[:, _A], f[:, _K], f[:, _N], f[:, _P]
            A = lpool[_grid(f[:, _LOFF], a0, k0, a, k, sent_l)]
            P = xp[_grid(f[:, _POFF], k0, n0, k, n, size_p)]
            R = rpool[_grid(f[:, _ROFF], p0, n0, p, n, sent_r)]
            out = torch.einsum("bak,bkn,bpn->bap", A, P, R)
            sig.index_add_(0, _grid(f[:, _OOFF], a0, p0, a, p,
                                    size_p).reshape(-1), out.reshape(-1))
    return sig[:size_p]


def chain_sigma(kernel: str, entry: str, xp, lpool, rpool, d: Dict,
                size_p: int):
    """Flat sigma [size_p] from the padded flat psi ``xp`` [size_p + 1]
    and the flat LW/RW pools through the chain core's ``kernel`` (C entry
    ``entry``: K8, or K7 for the tiled engine) on the device of ``xp``,
    ``d`` holding :func:`kernel_tables` there; CPU tensors run
    :func:`bucket_sigma_plain` (``d`` from :func:`plain_tables`)."""
    if xp.shape != (size_p + 1,) or lpool.dim() != 1 or rpool.dim() != 1:
        raise ValueError(f"{kernel}: psi {tuple(xp.shape)} (expected "
                         f"({size_p + 1},)), pools {lpool.dim()}-D / "
                         f"{rpool.dim()}-D (expected flat)")
    if xp.device.type == "cpu":
        return bucket_sigma_plain(xp, lpool, rpool, d, size_p)
    if not xp.is_cuda:
        raise ValueError(f"unsupported device {xp.device}")
    out = xp.new_zeros(size_p + 1)
    _kernels.launch(kernel, entry, xp.dtype, xp, lpool, rpool, d["items"],
                    d["ent"], d["ck"], d["n_chunks"], chain_mv.TILE, out)
    return out[:size_p]


def bucket_sigma(xp, lpool, rpool, d: Dict, size_p: int):
    """Sigma matvec (kernel K8, real types), :func:`chain_sigma`."""
    return chain_sigma(*BucketExecutor.KERNEL, xp, lpool, rpool, d, size_p)


def plain_tables(struct: Dict, device) -> Dict:
    """The tables :func:`bucket_sigma_plain` reads, on ``device``: the
    items (int64) and each bucket's item range and padded shape."""
    b = struct["bounds"]
    return {"items": torch.as_tensor(struct["items"], device=device),
            "buckets": [(int(b[i]), int(b[i + 1]), key)
                        for i, key in enumerate(struct["keys"])]}


def chain_tables(struct: Dict) -> Dict:
    """The host tables of the chain core (K8, K7) for ``struct``, built
    once and cached in it under ``_chain``: the items sorted by their sigma
    block (``ooff``, stable) as int32 [N, 8] (``items``), their chunks
    (``ops/chain_mv.py``: ``ent``, ``ck``, cut for the core's tile), the
    true FLOPs and ``seconds``, the build time of the order and the
    chunks."""
    tab = struct.get("_chain")
    if tab is None:
        t0 = time.perf_counter()
        it = struct["items"]
        it = it[np.argsort(it[:, _OOFF], kind="stable")]
        tab = chain_mv.chunk_tables(it)
        tab["items"] = _int32(it, "a chain item offset")
        tab["seconds"] = time.perf_counter() - t0
        struct["_chain"] = tab
    return tab


def kernel_tables(struct: Dict, device) -> Dict:
    """The tables K8 and K7 read, on ``device``: :func:`chain_tables`'s
    items, ``ent``, ``ck`` and ``n_chunks``, and their build ``seconds``."""
    tab = chain_tables(struct)
    d = chain_mv.device_tables(tab["items"], tab, device)
    d["seconds"] = tab["seconds"]
    return d


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------

class BucketExecutor:
    """Sigma-vector executor of one effective Hamiltonian on the chain
    core: kernel K8 here, kernel K7 in the subclass
    ``ops/tiled.TiledExecutor``, which differs only in ``KERNEL`` (launch
    key, C entry) and ``COMPLEX`` (complex types allowed).

    The bucket structure depends only on the triple/shape layout and is
    cached across center steps and sweeps via ``cache``/``cache_key`` (the
    reference keys it on ``(type(eff).__name__, eff.t)``, sweep.py:698-702,
    and checks a signature of the shapes on every hit); the LW/RW pools and
    the item tables are uploaded per executor.  ``t_struct``, ``t_pack``
    and ``t_tables`` hold the seconds spent on the struct (build or cache
    lookup), on packing and uploading the pools and on deriving (once per
    struct) and uploading the tables."""

    KERNEL = ("K8_bucket", "b2t_bucket")
    COMPLEX = False

    def __init__(self, eff, dtype=np.float64, cache: dict = None,
                 cache_key=None, device="cuda"):
        from ..runtime import resolve_device, torch_dtype
        if not self.COMPLEX and np.dtype(
                getattr(eff, "dtype", np.float64)).kind == "c":
            raise TypeError("the bucketed executor is real only (got a "
                            f"{np.dtype(eff.dtype)} effective Hamiltonian);"
                            " backend='torch_tiled' carries complex")
        torch_dtype(dtype, complex_ok=self.COMPLEX)
        self.size = eff.size
        self.size_p = padded_size(eff.size)
        self.dtype = np.dtype(dtype)
        self.device = resolve_device(device)
        t0 = time.perf_counter()
        lw_ids, rw_ids, lw_mats, rw_mats = operator_mats(eff)
        self.struct = cached_struct(eff, lw_ids, rw_ids, lw_mats, rw_mats,
                                    cache, cache_key)
        t1 = time.perf_counter()
        self.lpool = pack_pool(lw_mats, self.dtype, self.device)
        self.rpool = pack_pool(rw_mats, self.dtype, self.device)
        self._sync()
        t2 = time.perf_counter()
        self._dev = (plain_tables if self.device.type == "cpu"
                     else kernel_tables)(self.struct, self.device)
        self._sync()
        self.t_struct = t1 - t0
        self.t_pack = t2 - t1
        self.t_tables = time.perf_counter() - t2

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def pad(self, x: np.ndarray) -> np.ndarray:
        xp = np.zeros(self.size_p + 1, dtype=self.dtype)
        xp[:self.size] = x
        return xp

    def matvec_device(self, xp: torch.Tensor) -> torch.Tensor:
        """Flat sigma [size_p] of the padded psi ``xp`` [size_p + 1] on
        this executor's device (zero past ``size``)."""
        return chain_sigma(*self.KERNEL, xp, self.lpool, self.rpool,
                           self._dev, self.size_p)

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """H x for a host vector x [size]; float64 (complex128) host
        values."""
        xp = torch.as_tensor(self.pad(x), device=self.device)
        out = self.matvec_device(xp).cpu().numpy()[:self.size]
        return out.astype(np.complex128 if self.dtype.kind == "c"
                          else np.float64)

    def free(self):
        """Release the pools and tables of this executor."""
        self.lpool = self.rpool = self._dev = None

    def solve_ground_state(self, x0: np.ndarray, diag: np.ndarray,
                           conv_thrd: float = 1e-8, max_iter: int = 100,
                           max_subspace: int = 20):
        """Lowest eigenpair by the port's device Davidson around the
        executor's kernel (one solve per call; real float32/float64
        only).  Returns (theta, x [size] float64, n_iter)."""
        from .device_davidson import davidson
        if self.dtype.kind != "f":
            raise TypeError(f"solve_ground_state is real only "
                            f"(executor dtype {self.dtype})")
        dp = np.ones(self.size_p + 1, dtype=self.dtype)
        dp[:self.size] = diag
        th, xv, it = davidson(
            self.matvec_device, torch.as_tensor(dp, device=self.device),
            torch.as_tensor(self.pad(x0), device=self.device),
            conv_thrd=conv_thrd, max_iter=max_iter,
            max_subspace=max_subspace)
        return (float(th), xv.cpu().numpy().astype(np.float64)[:self.size],
                int(it))


# ---------------------------------------------------------------------------
# PlanExecutor: the padded stacks (kernel K18) and its plain twin
# ---------------------------------------------------------------------------

def plan_exec_plain(xp, buckets, sig_len: int):
    """Plain PyTorch version of K18: the reference's ``_execute_impl``
    bucket by bucket — ``P = xp[pidx]``, one batched einsum, a scatter-add
    into sigma [sig_len] through ``oidx``, indices past the end dropped."""
    sig = xp.new_zeros(sig_len)
    for (A, R, pidx, oidx) in buckets:
        out = torch.einsum("bak,bkn,bpn->bap", A, xp[pidx.long()], R)
        o = oidx.reshape(-1).long()
        keep = o < sig_len
        sig.index_add_(0, o[keep], out.reshape(-1)[keep])
    return sig


def plan_exec(xp, ex: "PlanExecutor"):
    """Sigma [size_p + 1] (slot size_p the spill of the sentinel, zero) of
    the padded psi ``xp`` [size_p + 1] through ``ex``'s buckets (kernel
    K18: the true items on the chain core, :meth:`PlanExecutor.k18_tables`),
    on the device of ``xp``; CPU tensors run :func:`plan_exec_plain`."""
    sig_len = ex.size_p + 1
    if xp.shape != (sig_len,):
        raise ValueError(f"plan_exec: psi {tuple(xp.shape)} (expected "
                         f"({sig_len},))")
    if xp.device.type == "cpu":
        return plan_exec_plain(xp, ex.device_buckets, sig_len)
    if not xp.is_cuda:
        raise ValueError(f"unsupported device {xp.device}")
    d = ex.k18_tables()
    out = xp.new_zeros(sig_len)
    _kernels.launch("K18_plan_exec", "b2t_plan_exec", xp.dtype, xp, ex.vals,
                    d["items"], d["ent"], d["ck"], d["n_chunks"],
                    chain_mv.TILE, out)
    return out


def plan_exec_part(xp, ex: "PlanExecutor", part: Dict):
    """This rank's partial sigma [size_p + 1] (kernel K22): ``ex``'s
    buckets cut to the rank's contiguous batch slices (``part`` from
    :meth:`PlanExecutor.rank_part`).  CPU tensors run
    :func:`plan_exec_plain` on the sliced buckets; CUDA tensors launch K22
    (K18's instance over the chunks of the rank's true items; nothing when
    the rank owns no item) or raise."""
    sig_len = ex.size_p + 1
    if xp.shape != (sig_len,):
        raise ValueError(f"plan_exec_part: psi {tuple(xp.shape)} (expected "
                         f"({sig_len},))")
    if xp.device.type == "cpu":
        return plan_exec_plain(xp, [
            tuple(a[i0:i1] for a in bk)
            for bk, (i0, i1) in zip(ex.device_buckets, part["slices"])],
            sig_len)
    if not xp.is_cuda:
        raise ValueError(f"unsupported device {xp.device}")
    out = xp.new_zeros(sig_len)
    d = part["chain"]
    if d["n_chunks"] > 0:
        _kernels.launch("K22_plan_exec_shard", "b2t_plan_exec_part",
                        xp.dtype, xp, ex.vals, d["items"], d["ent"], d["ck"],
                        d["n_chunks"], chain_mv.TILE, out,
                        units=d["n_chunks"])
    return out


class PlanExecutor:
    """Compiled sigma-vector plan for one effective-Hamiltonian center step
    on padded buckets (the reference's ``PlanExecutor``,
    exec_jax.py:75-128).

    Every triple goes to the bucket of its ``_round_dim`` shapes
    (a, k, n, p); per bucket, sorted by key, the batch is padded by
    ``_round_batch`` and the stacks A [B, a, k], R [B, p, n], pidx
    [B, k, n], oidx [B, a, p] are built as the reference builds them
    (zero blocks, sentinel index ``size_p``).  They are uploaded as one
    value pool ``vals`` and one int32 pool ``ints``; ``device_buckets``
    holds per bucket the four views into them.  ``items`` [N, 10] (int64)
    are the true items as K18 and K22 read them
    (:func:`plan_chain_tables`), one a triple, in bucket order, and
    ``slots`` [N, 2] (int64) the bucket and batch index each came from; a
    triple whose psi or sigma block does not have its LW/RW dims
    raises."""

    VEC_PAD = VEC_PAD   # flat psi/sigma vectors padded to multiples of this

    def __init__(self, eff, dtype=np.float64, device="cuda"):
        from ..runtime import resolve_device, torch_dtype, unpack_views
        if np.dtype(getattr(eff, "dtype", np.float64)).kind == "c":
            raise TypeError("PlanExecutor is real only (got a "
                            f"{np.dtype(eff.dtype)} effective Hamiltonian);"
                            " backend='torch_tiled' carries complex")
        tdt = torch_dtype(dtype)
        self.size = eff.size
        self.size_p = ((eff.size + self.VEC_PAD) // self.VEC_PAD) \
            * self.VEC_PAD
        self.dtype = np.dtype(dtype)
        self.device = resolve_device(device)
        buckets: Dict[Tuple[int, int, int, int], List] = {}
        for (m, lk, pk, rk, ok) in eff.triples:
            lb = eff.LW[m][lk]
            rb = eff.RW[m][rk]
            a0, k0 = lb.shape
            p0, n0 = rb.shape
            key = (_round_dim(a0), _round_dim(k0),
                   _round_dim(n0), _round_dim(p0))
            buckets.setdefault(key, []).append(
                (lb, rb, eff.offsets[pk], eff.shapes[pk], eff.offsets[ok],
                 eff.shapes[ok]))
        invalid = self.size_p   # sentinel index -> padded zero / spill slot
        vals, ints, chain, slots = [], [], [], []
        ov = 0
        for bi, ((a, k, n, p), items) in enumerate(sorted(buckets.items())):
            B = _round_batch(len(items))
            A = np.zeros((B, a, k), dtype=self.dtype)
            R = np.zeros((B, p, n), dtype=self.dtype)
            pidx = np.full((B, k, n), invalid, dtype=np.int32)
            oidx = np.full((B, a, p), invalid, dtype=np.int32)
            for b, (lb, rb, poff, pshape, ooff, oshape) in enumerate(items):
                a0, k0 = lb.shape
                p0, n0 = rb.shape
                if tuple(pshape) != (k0, n0) or tuple(oshape) != (a0, p0):
                    raise ValueError(f"PlanExecutor: psi block {pshape} / "
                                     f"sigma block {oshape} do not match "
                                     f"LW {(a0, k0)} and RW {(p0, n0)}")
                chain.append((ov + b * a * k, a0, k0, poff, n0,
                              ov + A.size + b * p * n, p0, ooff, k, n))
                slots.append((bi, b))
                A[b, :a0, :k0] = lb
                R[b, :p0, :n0] = rb
                kk, nn = pshape
                pidx[b, :kk, :nn] = (poff + np.arange(kk * nn)
                                     ).reshape(kk, nn)
                aa, pp = oshape
                oidx[b, :aa, :pp] = (ooff + np.arange(aa * pp)
                                     ).reshape(aa, pp)
            ov += A.size + R.size
            vals += [A, R]
            ints += [pidx, oidx]
        flat_v = np.concatenate([v.ravel() for v in vals]) if vals \
            else np.zeros(0, self.dtype)
        flat_i = np.concatenate([v.ravel() for v in ints]) if ints \
            else np.zeros(0, np.int32)
        self.vals = torch.as_tensor(flat_v, dtype=tdt, device=self.device)
        self.ints = torch.as_tensor(flat_i, device=self.device)
        v = unpack_views(self.vals, [x.shape for x in vals])
        i = unpack_views(self.ints, [x.shape for x in ints])
        self.device_buckets = tuple((v[2 * b], v[2 * b + 1], i[2 * b],
                                     i[2 * b + 1])
                                    for b in range(len(vals) // 2))
        self.items = np.asarray(chain, np.int64).reshape(-1, 10)
        self.slots = np.asarray(slots, np.int64).reshape(-1, 2)
        self._k18 = None
        self._parts: Dict[Tuple[int, int], Dict] = {}

    def chain_tables(self) -> Dict:
        """K18's host tables (:func:`plan_chain_tables` of ``items``),
        built on first use and kept."""
        if self._k18 is None:
            self._k18 = plan_chain_tables(self.items)
        return self._k18

    def k18_tables(self) -> Dict:
        """K18's tables on this executor's device (:func:`chain_tables`'
        ``items``, ``ent``, ``ck`` as ``ops/chain_mv.device_tables``, and
        the host build ``seconds``), uploaded once and kept."""
        tab = self.chain_tables()
        d = tab.get("dev")
        if d is None:
            d = tab["dev"] = chain_mv.device_tables(tab["items"], tab,
                                                    self.device)
            d["seconds"] = tab["seconds"]
        return d

    def rank_part(self, rank: int, world: int) -> Dict:
        """Rank ``rank`` of ``world``'s share of every bucket, built once
        and kept: the reference's ``P(axis)`` split of the batch after
        padding it to a multiple of ``world`` (parallel/shard.py:53-71),
        each rank taking ``ceil(B / world)`` items in rank order; the
        padding items add nothing, so a slice is cut at the batch's end.
        ``slices`` (i0, i1) per bucket (the plain version's), ``rows``
        (the rows of ``items`` whose batch index lies in their bucket's
        slice, in ``chain_mv.ket_round_robin``'s order), ``tables`` (:func:`plan_chain_tables` of those rows, cut
        at K18's FLOP band, so a share's chunks hold as much work as
        K18's; the share's own band cuts even a small share into about
        :data:`chain_mv.TARGET_CHUNKS` chunks, which timed slower on the
        card) and ``chain``, K22's copy of them on this executor's device
        (``ops/chain_mv.device_tables``)."""
        part = self._parts.get((rank, world))
        if part is not None:
            return part
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} outside a world of {world}")
        slices = []
        for A, _, _, _ in self.device_buckets:
            B = A.shape[0]
            per = -(-B // world)
            slices.append((min(rank * per, B), min((rank + 1) * per, B)))
        sl = np.asarray(slices, np.int64).reshape(-1, 2)[self.slots[:, 0]]
        b = self.slots[:, 1]
        rows = np.flatnonzero((b >= sl[:, 0]) & (b < sl[:, 1]))
        rows = rows[chain_mv.ket_round_robin(self.items[rows])]
        band = max(self.chain_tables()["flops"] / chain_mv.TARGET_CHUNKS,
                   1.0)
        tab = plan_chain_tables(self.items[rows], band)
        part = self._parts[(rank, world)] = {
            "slices": slices, "rows": rows, "tables": tab,
            "chain": chain_mv.device_tables(tab["items"], tab, self.device)}
        return part

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """H x for a host vector x [size]; float64 host values, as the
        reference's."""
        xp = np.zeros(self.size_p + 1, dtype=self.dtype)
        xp[:self.size] = x
        sig = plan_exec(torch.as_tensor(xp, device=self.device), self)
        return sig.cpu().numpy().astype(np.float64)[:self.size]
