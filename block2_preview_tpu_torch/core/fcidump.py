"""FCIDUMP reader/writer and model-Hamiltonian generators.

Counterpart of block2's FCIDUMP<FL> (reference
src/core/integral.hpp:540: TInt/V1Int/V4Int/V8Int storage, RHF 8-fold and UHF
4-fold permutation symmetry, IUHF section parsing) and the model generators
HubbardFCIDUMP / HeisenbergFCIDUMP (reference src/core/hubbard.hpp:31,
src/core/heisenberg.hpp:31).  We store integrals as dense numpy arrays with
all permutations materialized (host memory is cheap relative to the C++
packed-triangle storage; Cr2's K=42 g2e is ~25 MB in f64).

Copied from block2_preview_tpu/core/fcidump.py (the port keeps its own copy).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class FCIDUMP:
    n_sites: int
    n_elec: int
    twos: int
    ipg: int = 0                      # target point-group irrep (XOR label)
    orb_sym: Optional[np.ndarray] = None   # XOR labels, shape (n_sites,)
    const_e: float = 0.0
    uhf: bool = False
    general: bool = False             # IGENERAL=1: no integral permutations
    tgeneral: bool = False            # ITGENERAL=1: non-symmetric h1e
    # RHF: h1e (K,K), g2e (K,K,K,K) in chemist notation (ij|kl)
    # UHF: h1e = (ha, hb); g2e = (vaa, vbb, vab)
    h1e: object = None
    g2e: object = None
    # K/LZ symmetry labels (reference SZK/SZLZ modes, symmetry.hpp:738,864):
    # KSYM= per-orbital additive labels; KMOD= modulus (0 = plain integers,
    # the Lz case; N > 0 = mod-N momentum)
    k_sym: Optional[np.ndarray] = None
    k_mod: int = 0

    # ------------------------------------------------------------------
    @staticmethod
    def parse(path: str) -> "FCIDUMP":
        with open(path) as f:
            text = f.read()
        return FCIDUMP.parse_string(text)

    @staticmethod
    def parse_string(text: str) -> "FCIDUMP":
        # --- header: &FCI ... / or &END terminated namelist
        m = re.search(r"&FCI(.*?)(?:/|&END)", text, re.S | re.I)
        assert m is not None, "no FCIDUMP header"
        header = m.group(1)
        body = text[m.end():]

        def get_int(key, default=None):
            mm = re.search(key + r"\s*=\s*([0-9\-]+)", header, re.I)
            if mm is None:
                assert default is not None, key
                return default
            return int(mm.group(1))

        norb = get_int("NORB")
        nelec = get_int("NELEC")
        ms2 = get_int("MS2", 0)
        iuhf = get_int("IUHF", 0)
        isym = get_int("ISYM", 1)
        igeneral = get_int("IGENERAL", 0)
        itgeneral = get_int("ITGENERAL", 0)
        mo = re.search(r"ORBSYM\s*=\s*([0-9,\s]+)", header, re.I)
        if mo is not None:
            orbsym = np.array([int(x) for x in mo.group(1).replace(",", " ").split()],
                              dtype=np.int64)
            orb_sym = orbsym - 1      # MOLPRO d2h labels 1..8 -> XOR labels 0..7
        else:
            orb_sym = np.zeros(norb, dtype=np.int64)
        mk = re.search(r"KSYM\s*=\s*([0-9,\-\s]+)", header, re.I)
        k_sym = None
        if mk is not None:
            k_sym = np.array([int(x) for x in
                              mk.group(1).replace(",", " ").split()],
                             dtype=np.int64)
        k_mod = get_int("KMOD", 0) if mk is not None else 0

        fd = FCIDUMP(n_sites=norb, n_elec=nelec, twos=ms2,
                     ipg=max(isym - 1, 0), orb_sym=orb_sym, uhf=bool(iuhf),
                     general=bool(igeneral), tgeneral=bool(itgeneral),
                     k_sym=k_sym, k_mod=k_mod)

        # detect complex data: "re im i j k l" lines (DHF relativistic)
        is_complex = False
        for line in body.split("\n")[:50]:
            parts = line.split()
            if len(parts) == 6:
                try:
                    float(parts[1])
                    if "." in parts[1] or "e" in parts[1].lower() \
                            or "d" in parts[1].lower():
                        is_complex = True
                except ValueError:
                    pass
                break
        dtype = np.complex128 if is_complex else np.float64

        if not fd.uhf:
            h1e = np.zeros((norb, norb), dtype=dtype)
            g2e = np.zeros((norb, norb, norb, norb), dtype=dtype)
        else:
            ha = np.zeros((norb, norb))
            hb = np.zeros((norb, norb))
            vaa = np.zeros((norb, norb, norb, norb))
            vbb = np.zeros((norb, norb, norb, norb))
            vab = np.zeros((norb, norb, norb, norb))
            sections4 = [vaa, vbb, vab]
            sections2 = [ha, hb]
        section = 0

        def set_g2e_8fold(v, i, j, k, l, val):
            for (a, b, c, d) in ((i, j, k, l), (j, i, k, l), (i, j, l, k),
                                 (j, i, l, k), (k, l, i, j), (l, k, i, j),
                                 (k, l, j, i), (l, k, j, i)):
                v[a, b, c, d] = val

        def set_g2e_4fold(v, i, j, k, l, val):
            # (ij|kl) with i,j of spin A and k,l of spin B: no bra-ket swap
            for (a, b, c, d) in ((i, j, k, l), (j, i, k, l),
                                 (i, j, l, k), (j, i, l, k)):
                v[a, b, c, d] = val

        for line in body.split("\n"):
            line = line.strip()
            if not line:
                continue
            parts = line.split()
            if len(parts) < 5:
                continue
            if is_complex and len(parts) >= 6:
                val = complex(float(parts[0].replace("D", "E")),
                              float(parts[1].replace("D", "E")))
                i, j, k, l = (int(x) for x in parts[2:6])
            else:
                val = float(parts[0].replace("D", "E").replace("d", "e"))
                i, j, k, l = (int(x) for x in parts[1:5])
            if i == 0 and j == 0 and k == 0 and l == 0:
                if val != 0.0:
                    fd.const_e = val.real if is_complex else val
                section += 1
                continue
            if not fd.uhf:
                if k == 0 and l == 0:
                    if fd.tgeneral:
                        h1e[i - 1, j - 1] = val
                    else:
                        h1e[i - 1, j - 1] = val
                        h1e[j - 1, i - 1] = val
                elif fd.general:
                    g2e[i - 1, j - 1, k - 1, l - 1] = val
                else:
                    set_g2e_8fold(g2e, i - 1, j - 1, k - 1, l - 1, val)
            else:
                if k == 0 and l == 0:
                    hx = sections2[min(max(section - 3, 0), 1)]
                    hx[i - 1, j - 1] = val
                    hx[j - 1, i - 1] = val
                else:
                    idx = min(section, 2)
                    v = sections4[idx]
                    if idx < 2:
                        set_g2e_8fold(v, i - 1, j - 1, k - 1, l - 1, val)
                    else:
                        set_g2e_4fold(v, i - 1, j - 1, k - 1, l - 1, val)

        if not fd.uhf:
            fd.h1e, fd.g2e = h1e, g2e
        else:
            fd.h1e, fd.g2e = (ha, hb), (vaa, vbb, vab)
        return fd

    # ------------------------------------------------------------------
    def reorder(self, perm) -> "FCIDUMP":
        """New FCIDUMP with orbitals permuted: orbital i of the result is
        orbital perm[i] of self (reference integral.hpp FCIDUMP::reorder)."""
        p = np.asarray(perm, dtype=np.int64)
        assert not self.uhf, "reorder: RHF/general integrals"
        out = FCIDUMP(n_sites=self.n_sites, n_elec=self.n_elec,
                      twos=self.twos, ipg=self.ipg,
                      orb_sym=None if self.orb_sym is None
                      else self.orb_sym[p].copy(),
                      h1e=self.h1e[np.ix_(p, p)].copy(),
                      g2e=self.g2e[np.ix_(p, p, p, p)].copy(),
                      const_e=self.const_e)
        return out

    # ------------------------------------------------------------------
    def write(self, path: str, tol: float = 1e-13) -> None:
        """Write RHF-style FCIDUMP (reference integral.hpp FCIDUMP::write)."""
        assert not self.uhf, "writer: RHF/general integrals"
        n = self.n_sites
        with open(path, "w") as f:
            f.write(" &FCI NORB=%4d,NELEC=%3d,MS2=%2d,\n"
                    % (n, self.n_elec, self.twos))
            f.write("  ORBSYM=" + ",".join(
                str(int(x) + 1) for x in self.orb_sym) + ",\n")
            f.write("  ISYM=%d,\n" % (self.ipg + 1))
            if self.general:
                f.write("  IGENERAL=1,\n")
            f.write(" &END\n")

            def w(val, i, j, k, l):
                f.write(" %23.16E %3d %3d %3d %3d\n" % (val, i, j, k, l))

            g2e, h1e = self.g2e, self.h1e
            if self.general:
                for idx in zip(*np.nonzero(np.abs(g2e) > tol)):
                    w(float(g2e[idx].real), *(int(x) + 1 for x in idx))
            else:
                for i in range(n):
                    for j in range(i + 1):
                        for k in range(i + 1):
                            lmax = (j if k == i else k) + 1
                            for l in range(lmax):
                                if abs(g2e[i, j, k, l]) > tol:
                                    w(float(g2e[i, j, k, l]),
                                      i + 1, j + 1, k + 1, l + 1)
            for i in range(n):
                for j in range(i + 1):
                    if abs(h1e[i, j]) > tol:
                        w(float(h1e[i, j]), i + 1, j + 1, 0, 0)
            w(float(self.const_e), 0, 0, 0, 0)

    # ------------------------------------------------------------------
    @staticmethod
    def hubbard(n_sites: int, u: float = 2.0, t: float = 1.0,
                n_elec: Optional[int] = None, twos: int = 0) -> "FCIDUMP":
        """1D Hubbard chain, open boundary (reference src/core/hubbard.hpp:31)."""
        h1e = np.zeros((n_sites, n_sites))
        for i in range(n_sites - 1):
            h1e[i, i + 1] = h1e[i + 1, i] = -t
        g2e = np.zeros((n_sites,) * 4)
        for i in range(n_sites):
            g2e[i, i, i, i] = u
        return FCIDUMP(n_sites=n_sites, n_elec=n_elec or n_sites, twos=twos,
                       orb_sym=np.zeros(n_sites, dtype=np.int64),
                       h1e=h1e, g2e=g2e)
