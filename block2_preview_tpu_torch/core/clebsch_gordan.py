"""SU(2) recoupling coefficients: Clebsch-Gordan, Wigner 3j/6j/9j.

Counterpart of block2's SU2CG (reference
src/core/clebsch_gordan.hpp:58: sqrt-factorial tables, wigner_3j at ~100,
wigner_6j/racah, wigner_9j via 6j contraction, transpose_cg).  These are
host-side plan-compile-time quantities: the SU(2) sweep kernels consume them
baked into contraction-plan coefficients, exactly as the abelian plans bake
in MPO entry values.

All spins are passed DOUBLED (twice the physical value), matching the
reference's convention, so half-integer spins stay integral.

This module is the foundation of the spin-adapted (SU2) engine.

Copied from block2_preview_tpu/core/clebsch_gordan.py
(the port keeps its own copy).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

_MAXF = 200
_SQRT_FACT = np.ones(_MAXF)
for _i in range(1, _MAXF):
    _SQRT_FACT[_i] = _SQRT_FACT[_i - 1] * np.sqrt(_i)


def _sf(n: int) -> float:
    """sqrt(n!)"""
    assert 0 <= n < _MAXF
    return _SQRT_FACT[n]


def _triangle(tja: int, tjb: int, tjc: int) -> bool:
    return (abs(tja - tjb) <= tjc <= tja + tjb) and \
        ((tja + tjb + tjc) % 2 == 0)


@lru_cache(maxsize=None)
def wigner_3j(tja: int, tjb: int, tjc: int,
              tma: int, tmb: int, tmc: int) -> float:
    """Wigner 3j symbol (doubled arguments); Racah formula."""
    if tma + tmb + tmc != 0 or not _triangle(tja, tjb, tjc):
        return 0.0
    if (tja + tma) % 2 or (tjb + tmb) % 2 or (tjc + tmc) % 2:
        return 0.0
    ja_ma = (tja + tma) >> 1
    ja_mb = (tja - tma) >> 1
    jb_ma = (tjb + tmb) >> 1
    jb_mb = (tjb - tmb) >> 1
    jc_ma = (tjc + tmc) >> 1
    jc_mb = (tjc - tmc) >> 1
    if min(ja_ma, ja_mb, jb_ma, jb_mb, jc_ma, jc_mb) < 0:
        return 0.0
    g = (tja + tjb + tjc) >> 1
    a1 = (tja + tjb - tjc) >> 1
    a2 = (tja - tjb + tjc) >> 1
    a3 = (-tja + tjb + tjc) >> 1
    pref = (_sf(a1) * _sf(a2) * _sf(a3) / _sf(g + 1)
            * _sf(ja_ma) * _sf(ja_mb) * _sf(jb_ma) * _sf(jb_mb)
            * _sf(jc_ma) * _sf(jc_mb))
    kmin = max(0, (tjb - tjc - tma) >> 1, (tja - tjc + tmb) >> 1)
    kmax = min(a1, ja_mb, jb_ma)
    s = 0.0
    for k in range(kmin, kmax + 1):
        d = (_sf(k) ** 2 * _sf(a1 - k) ** 2 * _sf(ja_mb - k) ** 2
             * _sf(jb_ma - k) ** 2
             * _sf(((tjc - tjb + tma) >> 1) + k) ** 2
             * _sf(((tjc - tja - tmb) >> 1) + k) ** 2)
        s += (-1.0) ** k / d
    sign = (-1.0) ** ((tja - tjb - tmc) >> 1)
    return sign * pref * s


@lru_cache(maxsize=None)
def clebsch_gordan(tja: int, tjb: int, tjc: int,
                   tma: int, tmb: int, tmc: int) -> float:
    """<ja ma; jb mb | jc mc> (doubled arguments)."""
    return ((-1.0) ** ((tja - tjb + tmc) >> 1)
            * np.sqrt(tjc + 1.0)
            * wigner_3j(tja, tjb, tjc, tma, tmb, -tmc))


@lru_cache(maxsize=None)
def wigner_6j(tja: int, tjb: int, tjc: int,
              tjd: int, tje: int, tjf: int) -> float:
    """Wigner 6j symbol {ja jb jc; jd je jf} (doubled arguments)."""
    for (a, b, c) in ((tja, tjb, tjc), (tja, tje, tjf),
                      (tjd, tjb, tjf), (tjd, tje, tjc)):
        if not _triangle(a, b, c):
            return 0.0

    def delta(a, b, c):
        return (_sf((a + b - c) >> 1) * _sf((a - b + c) >> 1)
                * _sf((-a + b + c) >> 1) / _sf(((a + b + c) >> 1) + 1))

    pref = (delta(tja, tjb, tjc) * delta(tja, tje, tjf)
            * delta(tjd, tjb, tjf) * delta(tjd, tje, tjc))
    t1 = (tja + tjb + tjc) >> 1
    t2 = (tja + tje + tjf) >> 1
    t3 = (tjd + tjb + tjf) >> 1
    t4 = (tjd + tje + tjc) >> 1
    q1 = (tja + tjb + tjd + tje) >> 1
    q2 = (tjb + tjc + tje + tjf) >> 1
    q3 = (tja + tjc + tjd + tjf) >> 1
    s = 0.0
    for k in range(max(t1, t2, t3, t4), min(q1, q2, q3) + 1):
        num = _sf(k + 1) ** 2
        den = (_sf(k - t1) ** 2 * _sf(k - t2) ** 2 * _sf(k - t3) ** 2
               * _sf(k - t4) ** 2 * _sf(q1 - k) ** 2 * _sf(q2 - k) ** 2
               * _sf(q3 - k) ** 2)
        s += (-1.0) ** k * num / den
    return pref * s


@lru_cache(maxsize=None)
def wigner_9j(tja: int, tjb: int, tjc: int,
              tjd: int, tje: int, tjf: int,
              tjg: int, tjh: int, tji: int) -> float:
    """Wigner 9j via the single-sum 6j contraction (doubled arguments)."""
    kmin = max(abs(tja - tji), abs(tjb - tjf), abs(tjd - tjh))
    kmax = min(tja + tji, tjb + tjf, tjd + tjh)
    s = 0.0
    for k in range(kmin, kmax + 1, 2):
        s += ((-1.0) ** k * (k + 1)
              * wigner_6j(tja, tjb, tjc, tjf, tji, k)
              * wigner_6j(tjd, tje, tjf, tjb, k, tjh)
              * wigner_6j(tjg, tjh, tji, k, tja, tjd))
    return s


def racah(ta: int, tb: int, tc: int, td: int, te: int, tf: int) -> float:
    """Racah W coefficient (reference SU2CG::racah)."""
    return ((-1.0) ** ((ta + tb + tc + td) >> 1)
            * wigner_6j(ta, tb, te, td, tc, tf))


def transpose_cg(td: int, tl: int, tr: int) -> float:
    """Phase for transposing a rank-d tensor operator between bra/ket spaces
    (reference clebsch_gordan.hpp SU2CG::transpose_cg)."""
    return (-1.0) ** ((td + tl - tr) >> 1) * np.sqrt((tl + 1.0) / (tr + 1.0))
