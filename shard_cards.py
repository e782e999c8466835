"""The sharded path across cards: phase 11b's rank program of
``chip_smoke.py`` with one rank per card under NCCL (a world of four, then
of two), each rank running the seeded K=16 QC system at D=250 (phase 5's
start and schedule) on ``DMRG(backend="torch_resident", mesh=...)``,
held to the one-card port energy of the same start (1e-8 Ha), the ranks
to bitwise-equal energies and states, and ShardedPlanExecutor and the
sharded Gram to 1e-12.  Prints per rank and sweep the wall split, K20/K21
launches and units, and the time in all_reduce.  First, the launch path's
device check on two cards (:func:`device_check`).

Run from the repository root on a machine with four CUDA cards:
    python3 shard_cards.py
or only the device check (two cards or more):
    python3 shard_cards.py --device-check
"""

import os
import sys
import time

sys.path.insert(0, os.getcwd())

import chip_smoke as c  # noqa: E402


def device_check():
    """ops/_kernels.call refuses a tensor on another card than the current
    CUDA device, where the kernels launch: under torch.cuda.device(1), K19's
    dot of two tensors on card 0 must raise before anything runs, and of the
    same values on card 1 must run there and agree with torch.dot; the
    refused call counts no launch."""
    import torch
    from block2_preview_tpu_torch.ops import _kernels
    from block2_preview_tpu_torch.utils import gpu_smoke
    if torch.cuda.device_count() < 2:
        c.fail(f"the device check needs two cards, found "
               f"{torch.cuda.device_count()}")
    g = torch.Generator().manual_seed(5)
    a, b = (torch.rand(2048, generator=g).to("cuda:0") for _ in range(2))
    with torch.cuda.device(1):
        n0 = _kernels.launch_counts()["K19_probe"]
        try:
            gpu_smoke.dot(a, b)
        except ValueError as exc:
            if "current CUDA device is cuda:1" not in str(exc):
                c.fail(f"device check: refused for another reason: {exc}")
            print(f"[cards] device check: a tensor on cuda:0 under "
                  f"cuda:1 refused ({exc})", flush=True)
        else:
            c.fail("device check: a tensor on cuda:0 ran under cuda:1")
        if _kernels.launch_counts()["K19_probe"] != n0:
            c.fail("device check: the refused call counted a launch")
        a1, b1 = a.to("cuda:1"), b.to("cuda:1")
        got = gpu_smoke.dot(a1, b1)
        torch.cuda.synchronize(1)
        want = torch.dot(a1, b1)
        if got.device != a1.device or not torch.allclose(got, want,
                                                         rtol=1e-5):
            c.fail(f"device check: cuda:1 dot {float(got)} on {got.device},"
                   f" torch.dot {float(want)}")
    print(f"[cards] device check: the same dot on cuda:1 ran there, "
          f"{float(got):.6f} (torch.dot {float(want):.6f})", flush=True)


def main():
    from block2_preview_tpu_torch.runtime import resolve_device
    d = resolve_device("cuda")
    c.phase_device()
    c.phase_build()
    device_check()
    drv, mpo = c.hubbard_model(6)
    st = drv.get_random_mps(30, seed=3)
    drv.dmrg(mpo, st, bond_dims=[30], noises=[0], thrds=[1e-8],
             n_sweeps=2, tol=0, iprint=0, device=d)
    st = drv._last_dmrg.mps
    drv16, mpo16, _ = c.qc_system(16, 16)
    t0 = time.time()
    e5 = drv16.dmrg(mpo16, drv16.get_random_mps(250, seed=11), device=d,
                    **c.qc_sched(250))
    print(f"[cards] one card E {e5:.12f} in {time.time() - t0:.1f} s",
          flush=True)
    for r in drv16._last_dmrg.sweep_log:
        print(f"[cards] one card sweep wall {r['wall']:.1f} s Teff "
              f"{r['teff']:.1f} Teig {r['teig']:.1f} Tblk {r['tblk']:.1f}",
              flush=True)
    for world in (4, 2):
        cfg = dict(device="cuda", system="qc", n_orb=16, D=250, n_sweeps=2,
                   gram_state=st, threads=2, timeout=600, backend="nccl")
        t0 = time.time()
        res = c.run_ranks(cfg, world=world, deadline=600)
        print(f"[cards] world {world} nccl: {time.time() - t0:.1f} s spawn "
              f"to join, devices {[r['device'] for r in res]}", flush=True)
        c.check_shard_ranks(res, e5, "one card", True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--device-check"]:
        c.phase_device()
        c.phase_build()
        device_check()
    else:
        main()
