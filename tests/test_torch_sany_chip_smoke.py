"""chip_smoke.py's phase 14 on the CPU at a small size (the kernels' twins
stand in for the kernels on CPU tensors): 14a (Hubbard as a custom
(U1Fermi, U1) basis on torch_resident), 14b (a 2x2 t-J plaquette through
the SAnySU2 mode in a spawned process) and 14c (the PDMs of 13a's SU(2)
state through SU2 -> SZ), and each phase failing off its reference."""

import pytest
import torch

import chip_smoke
from test_torch_chip_smoke import _Ready

L4 = dict(L=4, D=16)
SU2_HUB4 = dict(chip_smoke.SU2_HUB, L=4, n_elec=4, D=20)
TJ2 = dict(chip_smoke.SU2_TJ, LX=2, LY=2, L=4, n_elec=2, D=40,
           sched=dict(bond_dims=[40], noises=[1e-4, 1e-5, 0.0],
                      thrds=[1e-11], n_sweeps=6, tol=1e-11))


def sz_hubbard4():
    """Phase 4's host energy at L=4 (the built-in SZ Hubbard chain)."""
    drv, mpo = chip_smoke.hubbard_model(4)
    return drv.dmrg(mpo, drv.get_random_mps(16, seed=7), backend="numpy",
                    **chip_smoke.hub_sched(16, 6))


def tj2_host():
    drv, mpo = chip_smoke.tj_system(TJ2)
    return drv.dmrg(mpo, drv.get_random_mps(40, seed=TJ2["seed"]),
                    backend="numpy", **chip_smoke.su2_sched(TJ2))


def hubbard4_state():
    """13a at L=4 with its state kept for 14c."""
    from block2_preview_tpu_torch.core.fcidump import FCIDUMP
    state = {}
    chip_smoke.phase_su2_hubbard(
        torch.device("cpu"), _Ready(chip_smoke.host_su2(SU2_HUB4)),
        _Ready(chip_smoke.su2_hubbard_ed(SU2_HUB4)), cfg=SU2_HUB4,
        keep=state)
    fd = FCIDUMP.hubbard(4, u=2, t=1)
    return state, fd.h1e, fd.g2e


def test_chip_smoke_sany_phases_on_cpu(capfd):
    dev = torch.device("cpu")
    runs = chip_smoke.spawn_procs({"14b": (chip_smoke.tj_proc,
                                           ("cpu", TJ2))}, "phase")
    counts = chip_smoke.phase_sany(dev, _Ready(chip_smoke.host_sany(**L4)),
                                   sz_hubbard4(), **L4)
    assert not any(counts.values())   # CPU tensors: the twins, no launch
    assert chip_smoke.phase_sany_su2(runs, anchor=tj2_host(),
                                     tol=1e-8) == (0, 0)
    state, h1e, g2e = hubbard4_state()
    assert state["ket"].engine._forward_next   # 13a ends backward
    c14 = chip_smoke.phase_su2_pdm(dev, state, h1e, g2e)
    assert c14["K17_npdm_gemm"] == 0
    assert not state["ket"].engine._forward_next
    out = capfd.readouterr().out
    for k in ("[14a sany] Hubbard-L4 as a custom ('U1Fermi', 'U1') basis",
              "[14b sany_su2] L=4 N=2 2S=0", "MPO 22 symbols",
              "[14b sany_su2] sweep 0", "[14b sany_su2] E ",
              "[14c su2_pdm] SU2 -> SZ", "a forward sweep first: True",
              "[14c su2_pdm] get_3pdm poly",
              "[14c su2_pdm order 3 get_3pdm poly vs det]"):
        assert k in out, k


def test_sany_phases_fail_off_their_references():
    """14a fails on an energy away from the host's or from phase 4's SZ
    energy; 14b away from its anchor and on a run that raised; 14c on a
    13a energy its PDMs do not give back."""
    dev = torch.device("cpu")
    e_host, secs = chip_smoke.host_sany(**L4)
    e_sz = sz_hubbard4()
    for host, sz in (((e_host + 1e-7, secs), e_sz),
                     ((e_host, secs), e_sz + 1e-5)):
        with pytest.raises(SystemExit):
            chip_smoke.phase_sany(dev, _Ready(host), sz, **L4)
    ok = {"14b": {"e": -1.0, "sweeps": 3, "K5_block": 0, "K7_tiled": 0}}
    assert chip_smoke.phase_sany_su2(lambda: ok, anchor=-1.0) == (0, 0)
    with pytest.raises(SystemExit):
        chip_smoke.phase_sany_su2(lambda: ok, anchor=-1.0 + 2e-7)
    # 3 electrons cannot make 2S=0: the spawned run raises
    runs = chip_smoke.spawn_procs(
        {"14b": (chip_smoke.tj_proc, ("cpu", dict(TJ2, n_elec=3)))},
        "phase")
    with pytest.raises(SystemExit):
        runs()
    state, h1e, g2e = hubbard4_state()
    state["e"] += 1e-7
    with pytest.raises(SystemExit):
        chip_smoke.phase_su2_pdm(dev, state, h1e, g2e)
