"""Device busy share and transfer times of the port's main path.

Runs the K=16 seeded QC two-sweep schedule of ``chip_smoke.py`` phase 5
(D=250, noise [1e-4, 0], Davidson |r|^2 < 1e-14, f64) twice on one CUDA
card: once untraced (warm-up; its sweep timers are printed), then under
``torch.profiler`` (CPU + CUDA activities).  From the traced run it
prints the wall time, the device time summed over the device-side rows
of ``key_averages()`` (kernels, copies and memsets; the ``aten::`` rows
would count their kernels' time again), the busy share (device time /
wall), the device-to-host and host-to-device copy time and count, and
the heaviest device rows.

Run from the repository root:
    python3 profile_port.py [--cprofile N]
``--cprofile N`` runs the untraced run under cProfile and prints its N
heaviest host functions by cumulative time.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time


def _self_device_us(e) -> float:
    for k in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(e, k, None)
        if v is not None:
            return float(v)
    return 0.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cprofile", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        sys.exit(1)
    import chip_smoke
    from block2_preview_tpu_torch.ops import _kernels
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    _kernels.lib()
    drv, mpo, _ = chip_smoke.qc_system(16, 16)
    sched = dict(bond_dims=[250, 250], noises=[1e-4, 0], thrds=[1e-14],
                 n_sweeps=2, tol=0, iprint=0)

    def run():
        t0 = time.time()
        e = drv.dmrg(mpo, drv.get_random_mps(250, seed=11), device="cuda",
                     **sched)
        torch.cuda.synchronize()
        return e, time.time() - t0

    if args.cprofile:
        import cProfile
        import pstats
        cp = cProfile.Profile()
        e, wall = cp.runcall(run)
        pstats.Stats(cp).sort_stats("cumulative").print_stats(args.cprofile)
    else:
        e, wall = run()
    s = drv._last_dmrg
    print(f"[untraced] E {e:.10f} wall {wall:.2f} s", flush=True)
    for i, r in enumerate(s.sweep_log):
        print(f"[untraced] sweep {i} wall {r['wall']:.2f} Teff "
              f"{r['teff']:.2f} Teig {r['teig']:.2f} Tdm {r['tdm']:.2f} "
              f"Tblk {r['tblk']:.2f}", flush=True)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        e, wall = run()
    from torch.autograd import DeviceType
    rows = [r for r in prof.key_averages()
            if getattr(r, "device_type", None) == DeviceType.CUDA]
    dev_us = sum(_self_device_us(r) for r in rows)
    d2h = [r for r in rows if "DtoH" in r.key or "Device -> Pageable" in r.key
           or "Device -> Pinned" in r.key]
    h2d = [r for r in rows if "HtoD" in r.key or "Pageable -> Device" in r.key
           or "Pinned -> Device" in r.key]
    print(f"[traced] E {e:.10f} wall {wall:.2f} s  device time "
          f"{dev_us / 1e6:.3f} s  busy {100 * dev_us / 1e6 / wall:.2f}%",
          flush=True)
    for what, sel in (("device-to-host", d2h), ("host-to-device", h2d)):
        print(f"[traced] {what} copies {sum(r.count for r in sel)}  "
              f"{sum(_self_device_us(r) for r in sel) / 1e3:.1f} ms  "
              f"({', '.join(sorted({r.key for r in sel}))})", flush=True)
    top = sorted(rows, key=_self_device_us, reverse=True)[:15]
    for r in top:
        us = _self_device_us(r)
        if us <= 0:
            break
        print(f"[traced] {us / 1e3:10.1f} ms  {r.count:6d}x  {r.key[:90]}",
              flush=True)


if __name__ == "__main__":
    main()
