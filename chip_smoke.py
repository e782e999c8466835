"""Chip smoke test of the PyTorch + CUDA port (block2_preview_tpu_torch).

Drives the port's main path on one CUDA card and checks it against the
JAX package's jax-free host reference (backend="numpy"):

  1. device    card name and power limit (nvidia-smi), torch / CUDA
  2. build     nvcc builds kernels K1-K4 from block2_preview_tpu_torch/csrc
  4. parity    Hubbard-L8, D=80, 6 sweeps with noise, f64: |dE| < 1e-8 Ha
  5. full      seeded K=16 quantum-chemistry Hamiltonian (16 electrons,
               full QC MPO), D=[250, 250], noise [1e-4, 0], Davidson
               |r|^2 < 1e-14, f64: |dE| < 1e-6 Ha, every kernel
               launched, no host redo
  3. kernels   each kernel against its plain PyTorch twin on the card, f64
               and f32, at a mid-chain site of the MPS that phase 5
               leaves — the shapes the main path gives the kernels (it
               runs last for that reason; its launches are not counted) —
               and again at the mid-chain site of a Hubbard-L16 MPS of
               bond dimension 1000, whose plan picks K1's T=128 tiles

Run from the repository root:  python3 chip_smoke.py
It needs one CUDA card and exits non-zero (printing no result) without
one.  The last line is {"ok": true, "device": {...}}; the line before it
is the per-kernel JSON summary.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np

F64_TOL = 1e-11     # kernel vs twin, relative to max |twin|
F32_TOL = 1e-5
HUB_TOL = 1e-8      # Ha, phase 4
QC_TOL = 1e-6       # Ha, phase 5


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def seeded_qc_integrals(n_orb: int, n_aux: int = 32, seed: int = 1234):
    """8-fold symmetric PSD two-electron integrals g2e = sum_P L_P (x) L_P
    (symmetric L_P, scale 0.15) and h1e = sym(0.1 N) + diag(linspace(-2,
    1)) — a dense QC Hamiltonian whose MPO has the full QC structure."""
    rng = np.random.default_rng(seed)
    n = 0.1 * rng.standard_normal((n_orb, n_orb))
    h1e = 0.5 * (n + n.T) + np.diag(np.linspace(-2.0, 1.0, n_orb))
    g2e = np.zeros((n_orb,) * 4)
    for _ in range(n_aux):
        a = 0.15 * rng.standard_normal((n_orb, n_orb))
        lp = 0.5 * (a + a.T)
        g2e += np.einsum("ij,kl->ijkl", lp, lp)
    return h1e, g2e


def qc_system(n_orb: int, n_elec: int):
    from block2_preview_tpu_torch.driver.core import DMRGDriver, SymmetryTypes
    h1e, g2e = seeded_qc_integrals(n_orb)
    drv = DMRGDriver(symm_type=SymmetryTypes.SZ)
    drv.initialize_system(n_sites=n_orb, n_elec=n_elec, spin=0)
    t0 = time.time()
    mpo = drv.get_qc_mpo(h1e=h1e, g2e=g2e, ecore=0.0)
    return drv, mpo, time.time() - t0


def time_ms(fn, device, reps: int = 5) -> float:
    """Mean device time of fn() over reps launches (CUDA events), after
    one warm-up call; on the CPU the host clock."""
    import torch
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def rel_err(a, b):
    scale = max(float(b.abs().max()), 1e-300)
    return float((a - b).abs().max()) / scale, float((a - b).abs().max())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"[1 device] {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  python {sys.version.split()[0]}",
          flush=True)


def ptxas_usage(log: str):
    """(kernel<type,T>, registers, spill line) per entry function of a
    ptxas -v log."""
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            k = re.search(r"([a-z][a-z_]*_kernel)I([df])(?:Li(\d+)E)?",
                          m.group(1))
            name = (f"{k.group(1)}<{'double' if k.group(2) == 'd' else 'float'}"
                    f"{',' + k.group(3) if k.group(3) else ''}>"
                    if k else m.group(1))
            spill = ""
        elif "spill stores" in ln:
            spill = ln.strip()
        else:
            m = re.search(r"Used (\d+) registers", ln)
            if m and name is not None:
                out.append((name, int(m.group(1)), spill))
                name = None
    return out


def phase_build():
    from block2_preview_tpu_torch.ops import _kernels
    t0 = time.time()
    dt = _kernels.build()
    _kernels.lib()
    print(f"[2 build] nvcc sm_90a {dt:.1f} s (load {time.time() - t0:.1f} s)"
          f" -> {_kernels.library_path().name}", flush=True)
    log = _kernels.build_log or (_kernels.BUILD_DIR / "build.log").read_text()
    usage = ptxas_usage(log)
    if not usage:
        fail("no ptxas register report in the build log")
    for name, regs, spill in usage:
        if name.startswith("mv_kernel") or not spill.startswith("0 bytes "
                                                                "stack"):
            print(f"    ptxas {name}: {regs} registers; {spill}", flush=True)


def mid_site(mpo, mps, t):
    """The environments a two-site center t needs, for a given MPS."""
    from block2_preview_tpu.dmrg.effective import EffectiveHamiltonian2
    from block2_preview_tpu.dmrg.environment import MovingEnvironment
    me = MovingEnvironment(mpo, mps)
    for s in range(mpo.n_sites - 1, t + 1, -1):
        me.update_right(s)
    for s in range(t):
        me.update_left(s)
    return me, EffectiveHamiltonian2(me, t, assemble=False)


def wide_system(L: int = 16, D: int = 1000):
    """Hubbard-L (U=2, t=1, half filling) MPO and a random MPS of bond
    dimension D.  At L=16, D=1000 the mid-chain center's p90 block
    dimension is 192, so K1 runs with T=128 tiles there (the D>=500 QC
    regime); the Hubbard MPO keeps the host environments cheap."""
    from block2_preview_tpu.core.fcidump import FCIDUMP
    from block2_preview_tpu_torch.driver.core import DMRGDriver, SymmetryTypes
    fd = FCIDUMP.hubbard(L, u=2, t=1)
    drv = DMRGDriver(symm_type=SymmetryTypes.SZ)
    drv.initialize_system(n_sites=L, n_elec=L, spin=0)
    mpo = drv.get_qc_mpo(h1e=fd.h1e, g2e=fd.g2e, ecore=fd.const_e)
    return mpo, drv.get_random_mps(D, seed=13)


def phase_kernels(device, mpo, mps, t, tile=None):
    """K1-K4 against their twins at site t; returns the summary rows.
    With ``tile`` set, the plan must pick that K1 tile size."""
    import torch
    from block2_preview_tpu_torch.ops import mixv4, resident, tilev2
    from block2_preview_tpu_torch.ops._kernels import KERNELS
    from block2_preview_tpu_torch.ops.stacked import env_pool
    me, eff = mid_site(mpo, mps, t)
    tk = eff.target
    g = mpo.group
    flb, frb = eff.bra_space.fl, eff.bra_space.fr
    flk, frk = eff.ket_space.fl, eff.ket_space.fr
    kw = {"lw": dict(bond_is_first=True, join_on_input=True,
                     active={q for (q, _) in eff.bra_space.keys},
                     fused_ket=flk,
                     active_ket={q for (q, _) in eff.ket_space.keys}),
          "rw": dict(bond_is_first=False, join_on_input=False,
                     comp_target=tk, comp_target_ket=tk,
                     active={q for (_, q) in eff.bra_space.keys},
                     fused_ket=frk,
                     active_ket={q for (_, q) in eff.ket_space.keys})}
    envs = {"lw": (me.left_envs[t], mpo.bond_dqs[t], mpo.tensors[t],
                   mpo.site_quanta[t], flb),
            "rw": (me.right_envs[t + 2], mpo.bond_dqs[t + 2],
                   mpo.tensors[t + 1], mpo.site_quanta[t + 1], frb)}
    plans, host_pools = {}, {}
    for side, (env, dqs, ent, quanta, fused) in envs.items():
        meta, host_pools[side] = env_pool(env, dqs, np.float64)
        plans[side] = resident.build_mix_plan(
            meta, ent, quanta, fused, group=g,
            out_bond_dqs=mpo.bond_dqs[t + 1], **kw[side])
    pl, pr = plans["lw"], plans["rw"]
    ex = tilev2.MatvecV2(eff.ket_space, pl.meta_out, pr.meta_out, g, tk,
                         dtype=np.float64, bra_space=eff.bra_space)
    s = ex.struct
    if tile is not None and s["T"] != tile:
        fail(f"site {t}: K1 plan picked T={s['T']}, expected {tile}")
    dv = ex.to_device(device)
    xh = ex.pad(np.random.default_rng(5).standard_normal(eff.size))
    ds = resident.build_diag_struct(eff.ket_space, pl.meta_out, pr.meta_out,
                                    s["T"], s["nt2"], s["sig_idx"])
    dd = resident.diag_tables(ds, device)
    rows = {}
    for dtype, tol in ((np.float64, F64_TOL), (np.float32, F32_TOL)):
        tdt = torch.float64 if dtype == np.float64 else torch.float32
        pools = {}
        for side, plan in plans.items():
            ep = torch.as_tensor(host_pools[side], dtype=tdt, device=device)
            d = mixv4.plan_tables(plan, device, tdt)
            otp = mixv4._cap_class(plan.out_total + 1)

            def k3(fn, ep=ep, d=d, otp=otp):
                return fn(ep, d["wpool"], d,
                          torch.zeros(otp + 1, dtype=tdt, device=device))

            o_k, o_t = k3(mixv4.mix_exec), k3(mixv4.mix_twin)
            _check(rows, "K3_mix", dtype, side, o_k, o_t, tol,
                   time_ms(lambda: k3(mixv4.mix_exec), device),
                   time_ms(lambda: k3(mixv4.mix_twin), device),
                   f"items {plan.it.shape[0]} tasks {d['n2']}")

            def k4(fn, d=d, o=o_t[:otp], plan=plan):
                return fn(o, d, torch.zeros(plan.ncap_out + 1, dtype=tdt,
                                            device=device))

            s_k, s_t = k4(mixv4.place_exec), k4(mixv4.place_twin)
            _check(rows, "K4_place", dtype, side, s_k, s_t, tol,
                   time_ms(lambda: k4(mixv4.place_exec), device),
                   time_ms(lambda: k4(mixv4.place_twin), device),
                   f"windows {plan.pit.shape[0]} tasks {d['np']}")
            pools[side] = s_t
        xp = torch.as_tensor(xh, dtype=tdt, device=device)

        def k1(fn):
            return fn(xp, pools["lw"], pools["rw"], dv, s["T"], s["nt2"])

        _check(rows, "K1_matvec", dtype, "", k1(tilev2.mv_exec),
               k1(tilev2.mv_twin), tol,
               time_ms(lambda: k1(tilev2.mv_exec), device),
               time_ms(lambda: k1(tilev2.mv_twin), device),
               f"T {s['T']} items {s['it'].shape[0]} units {dv['n_units']} "
               f"size {eff.size} GFLOP {s['flops'] / 1e9:.2f}")

        def k2(fn):
            return fn(pools["lw"], pools["rw"], dd)

        _check(rows, "K2_diag", dtype, "", k2(resident.diag_exec),
               k2(resident.diag_twin), tol,
               time_ms(lambda: k2(resident.diag_exec), device),
               time_ms(lambda: k2(resident.diag_twin), device),
               f"tasks {ds['a4'].shape[1]}")
    out = []
    for name, info in KERNELS.items():
        r = rows[name]
        out.append({"name": name, "route": info.route,
                     "source": info.source, "replaces": info.replaces,
                     "launches": 0, "max_abs_err": r["max_abs_err"],
                     "ms": r["ms"], "plain_ms": r["plain_ms"]})
    return out


def _check(rows, name, dtype, side, got, ref, tol, ms, plain_ms, shape):
    import torch
    if got.is_cuda:
        torch.cuda.synchronize()
    rel, mabs = rel_err(got, ref)
    tag = "f64" if dtype == np.float64 else "f32"
    print(f"[3 kernels] {name:9s} {tag} {side:2s} rel {rel:.2e} "
          f"abs {mabs:.2e}  kernel {ms:.3f} ms  twin {plain_ms:.3f} ms  "
          f"({shape})", flush=True)
    if not rel <= tol:
        fail(f"{name} {tag} {side}: rel err {rel:.3e} > {tol:.0e}")
    if dtype == np.float64:
        r = rows.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0,
                                   "plain_ms": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], mabs)
        r["ms"] += ms
        r["plain_ms"] += plain_ms


def phase_hubbard(device):
    from block2_preview_tpu.core.fcidump import FCIDUMP
    from block2_preview_tpu.dmrg.sweep import DMRG as RefDMRG
    from block2_preview_tpu_torch.driver.core import DMRGDriver, SymmetryTypes
    L, D, ns = 8, 80, 6
    fd = FCIDUMP.hubbard(L, u=2, t=1)
    drv = DMRGDriver(symm_type=SymmetryTypes.SZ)
    drv.initialize_system(n_sites=L, n_elec=L, spin=0)
    mpo = drv.get_qc_mpo(h1e=fd.h1e, g2e=fd.g2e, ecore=fd.const_e)
    sched = dict(bond_dims=[D] * ns, noises=[1e-5] * ns + [0],
                 thrds=[1e-10], n_sweeps=ns, tol=0)
    t0 = time.time()
    e_port = drv.dmrg(mpo, drv.get_random_mps(D, seed=7), iprint=0,
                      device=device, **sched)
    t1 = time.time()
    e_ref = RefDMRG(mpo, drv.get_random_mps(D, seed=7), backend="numpy",
                    iprint=0).solve(sched["bond_dims"], sched["noises"],
                                    sched["thrds"], n_sweeps=ns, tol=0)
    de = e_port - e_ref
    print(f"[4 parity] Hubbard-L8 D={D} x{ns} port {e_port:.12f} "
          f"({t1 - t0:.1f} s) host {e_ref:.12f} ({time.time() - t1:.1f} s) "
          f"dE {de:.2e}", flush=True)
    if not abs(de) < HUB_TOL:
        fail(f"Hubbard parity |dE| {abs(de):.3e} >= {HUB_TOL}")


def phase_full(device, drv, mpo, D=250, n_orb=16):
    """Main path at full width; returns the kernel launch counts of the
    run and the MPS it leaves.

    Two sweeps from a random MPS are far from converged, so the energy
    after them depends to first order on each site's eigenvector, and
    the port's Davidson (M=20, thick restart) and the host's (M=30,
    restart to one vector) stop at different vectors within the
    residual threshold.  At |r|^2 < 1e-10 that alone moves the two
    energies ~2e-6 Ha apart (K=10, D=80 on the CPU: port - host 2.0e-6,
    while the port and the JAX package's jax_resident backend, the same
    Davidson family, agree to 3.8e-8; at 1e-14: 5.9e-9 and 1.5e-10), so
    both solve to |r|^2 < 1e-14 and the gap measures the port, not the
    threshold."""
    import torch
    from block2_preview_tpu.dmrg.sweep import DMRG as RefDMRG
    from block2_preview_tpu_torch.ops import _kernels
    sched = dict(bond_dims=[D, D], noises=[1e-4, 0], thrds=[1e-14],
                 n_sweeps=2, tol=0)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _kernels.reset_counts()
    ket = drv.get_random_mps(D, seed=11)
    t0 = time.time()
    e_port = drv.dmrg(mpo, ket, iprint=0, device=device, **sched)
    t1 = time.time()
    counts = _kernels.launch_counts()
    solver = drv._last_dmrg
    for i, (e, wall, teff, teig, tdm, tblk) in enumerate(solver.sweep_log):
        print(f"[5 full] sweep {i} D={D} E {e:.10f} wall {wall:.1f} s  "
              f"Teff {teff:.1f} Teig {teig:.1f} Tdm {tdm:.1f} "
              f"Tblk {tblk:.1f}", flush=True)
    mem = (torch.cuda.max_memory_allocated() / 2 ** 30
           if device.type == "cuda" else float("nan"))
    print(f"[5 full] port total {t1 - t0:.1f} s  launches {counts}  "
          f"max_memory_allocated {mem:.2f} GiB  host_redo_count "
          f"{solver.host_redo_count}", flush=True)
    e_ref = RefDMRG(mpo, drv.get_random_mps(D, seed=11), backend="numpy",
                    iprint=0).solve(sched["bond_dims"], sched["noises"],
                                    sched["thrds"], n_sweeps=2, tol=0)
    de = e_port - e_ref
    print(f"[5 full] K={n_orb} QC host reference {e_ref:.10f} "
          f"({time.time() - t1:.1f} s)  port {e_port:.10f}  dE {de:.2e}",
          flush=True)
    if not abs(de) < QC_TOL:
        fail(f"QC |dE| {abs(de):.3e} >= {QC_TOL}")
    if solver.host_redo_count != 0:
        fail(f"host_redo_count {solver.host_redo_count}")
    return counts, ket


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    try:
        from block2_preview_tpu_torch.runtime import resolve_device
    except ImportError as exc:
        fail(f"the port package is not importable ({exc}); run from the "
             "repository root")
    device = resolve_device("cuda")
    phase_device()
    phase_build()
    n_orb, D = 16, 250
    drv, mpo, t_mpo = qc_system(n_orb, n_orb)
    nbond = max(len(b) for b in mpo.bond_dqs)
    print(f"[5 full] K={n_orb} QC MPO built in {t_mpo:.1f} s, max MPO "
          f"bond {nbond}", flush=True)
    phase_hubbard(device)
    counts, ket = phase_full(device, drv, mpo, D=D, n_orb=n_orb)
    if not all(c > 0 for c in counts.values()):
        fail(f"a kernel of the path was never launched: {counts}")
    rows = phase_kernels(device, mpo, ket, n_orb // 2 - 1)
    t0 = time.time()
    wide = wide_system()
    print(f"[3 kernels] Hubbard-L16 D=1000 site 7 (T=128 tiles; MPS built "
          f"in {time.time() - t0:.1f} s)", flush=True)
    phase_kernels(device, *wide, 7, tile=128)
    if "jax" in sys.modules:
        fail("JAX was imported")
    for r in rows:
        r["launches"] = counts[r["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
