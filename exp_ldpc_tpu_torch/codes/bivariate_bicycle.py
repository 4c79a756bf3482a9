"""Bivariate bicycle (BB) codes — two-block group-algebra codes over Z_l x Z_m.

The modern production-scale qLDPC family (Bravyi et al., "High-threshold and
low-overhead fault-tolerant quantum memory", arXiv:2308.07915): check matrices

    H_x = [A | B],   H_z = [B^T | A^T],

with A and B three-term polynomials in the commuting circulant generators
x = S_l (x) I_m and y = I_l (x) S_m.  Extends the reference's quasicyclic
lifted-product family (``reference/python/qldpc/qc_lifted_product_code.py``
builds the closely related one-variable circulant lifts) to the two-variable
group algebra F2[Z_l x Z_m]; everything downstream (storage circuits, the
batched TPU decoders, sweeps) consumes the resulting ``QuantumCode``
unchanged.
"""
from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import numpy as np
from scipy import sparse

from ..core import QuantumCode, QuantumCodeChecks
from .homological import get_logicals
from .qc_meta import BlockCirculantMeta

__all__ = ["bivariate_bicycle_code", "gross_code", "BB_CODES"]


def _monomial(l: int, m: int, i: int, j: int) -> np.ndarray:
    """x^i y^j as an (lm, lm) 0/1 matrix, x = S_l ⊗ I_m, y = I_l ⊗ S_m."""
    Sx = np.roll(np.eye(l, dtype=np.uint8), i % l, axis=1)
    Sy = np.roll(np.eye(m, dtype=np.uint8), j % m, axis=1)
    return np.kron(Sx, Sy)


def _poly(l: int, m: int, terms: Iterable[Tuple[int, int]]) -> np.ndarray:
    out = np.zeros((l * m, l * m), dtype=np.uint8)
    for i, j in terms:
        out ^= _monomial(l, m, i, j)
    return out


def bivariate_bicycle_code(
    l: int,
    m: int,
    a_terms: Sequence[Tuple[int, int]],
    b_terms: Sequence[Tuple[int, int]],
    compute_logicals: bool = False,
) -> QuantumCode:
    """[[2lm, k]] bivariate bicycle code.

    ``a_terms`` / ``b_terms`` are exponent pairs (i, j) meaning the monomial
    x^i y^j; e.g. the gross code's A = x^3 + y + y^2 is [(3,0),(0,1),(0,2)].
    """
    A = _poly(l, m, a_terms)
    B = _poly(l, m, b_terms)
    hx = sparse.csr_matrix(np.hstack([A, B]))
    hz = sparse.csr_matrix(np.hstack([B.T, A.T]))
    checks = QuantumCodeChecks(hx.astype(np.uint32), hz.astype(np.uint32))
    logicals = get_logicals(checks, compute_logicals, check_complex=True)
    # both sectors are natively grids of circulant blocks over Z_l x Z_m
    return QuantumCode(checks, logicals, qc_meta=BlockCirculantMeta(dims=(l, m)))


# named instances from arXiv:2308.07915 Table 3 (distances cited, not checked)
BB_CODES = {
    # name: (l, m, A terms, B terms, [[n, k, d]])
    "bb_72_12_6": (6, 6, [(3, 0), (0, 1), (0, 2)], [(0, 3), (1, 0), (2, 0)], (72, 12, 6)),
    "bb_90_8_10": (15, 3, [(9, 0), (0, 1), (0, 2)], [(0, 0), (2, 0), (7, 0)], (90, 8, 10)),
    "bb_108_8_10": (9, 6, [(3, 0), (0, 1), (0, 2)], [(0, 3), (1, 0), (2, 0)], (108, 8, 10)),
    "gross": (12, 6, [(3, 0), (0, 1), (0, 2)], [(0, 3), (1, 0), (2, 0)], (144, 12, 12)),
    "bb_288_12_18": (12, 12, [(3, 0), (0, 2), (0, 7)], [(0, 3), (1, 0), (2, 0)], (288, 12, 18)),
}


def gross_code(compute_logicals: bool = False) -> QuantumCode:
    """The [[144, 12, 12]] gross code (arXiv:2308.07915)."""
    l, m, a, b, _nkd = BB_CODES["gross"]
    return bivariate_bicycle_code(l, m, a, b, compute_logicals=compute_logicals)
