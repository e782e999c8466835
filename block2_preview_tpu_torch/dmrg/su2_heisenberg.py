"""The SU(2) Heisenberg engine under its older module name.

Copied from block2_preview_tpu/dmrg/su2_heisenberg.py:1-9 (the port keeps
its own copy): the Heisenberg prototype grew into the generic spin-adapted
engine of su2_spin.py (arbitrary site spin, target spin and reduced MPO),
host numpy with no device path.  See that module for the conventions."""

from .su2_spin import (SU2HeisenbergDMRG, SU2SpinDMRG, coupled_factor,
                       heisenberg_entries, spin_reduced_element)

__all__ = ["SU2HeisenbergDMRG", "SU2SpinDMRG", "coupled_factor",
           "heisenberg_entries", "spin_reduced_element"]
