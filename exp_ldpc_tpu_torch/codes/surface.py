"""Toric and (unrotated) surface codes as hypergraph products of repetition
codes.

The reference constructs only random-graph HGP codes
(``reference/python/qldpc/hypergraph_product_code.py``); the
topological-code special cases fall out of the same homological product
(``codes/homological.py``) applied to the cycle / path repetition codes, and
give users the standard benchmarking family:

  * ``toric_code(L)``   — HGP(ring_L, ring_L)  = [[2L^2, 2, L]]
  * ``surface_code(L)`` — HGP(path_L, path_L)  = [[L^2 + (L-1)^2, 1, L]]
"""
from __future__ import annotations

from typing import Optional

import numpy as np
from scipy import sparse

from ..core import QuantumCode
from .homological import homological_product

__all__ = ["repetition_code_checks", "toric_code", "surface_code"]


def repetition_code_checks(num_bits: int, periodic: bool = False) -> sparse.csr_matrix:
    """Check matrix of the length-``num_bits`` repetition code.

    Path (open) form is (num_bits-1, num_bits) full rank; ring (periodic)
    form is (num_bits, num_bits) with a one-dimensional kernel."""
    if num_bits < 2:
        raise ValueError("repetition code needs at least 2 bits")
    checks = num_bits if periodic else num_bits - 1
    rows = np.repeat(np.arange(checks), 2)
    cols = np.stack(
        [np.arange(checks), (np.arange(checks) + 1) % num_bits], axis=1
    ).reshape(-1)
    return sparse.csr_matrix(
        (np.ones(rows.shape[0], dtype=np.uint8), (rows, cols)),
        shape=(checks, num_bits),
    )


def _repetition_product(L: int, periodic: bool,
                        compute_logicals: Optional[bool]) -> QuantumCode:
    H = repetition_code_checks(L, periodic=periodic)
    # same boundary/coboundary convention as biregular_hgp (codes/hgp.py):
    # boundary (num_data, num_checks), product with its dual complex
    boundary = H.T.astype(int)
    return homological_product(
        boundary, boundary.T, compute_logicals=compute_logicals
    )


def toric_code(L: int, compute_logicals: Optional[bool] = None) -> QuantumCode:
    """[[2L^2, 2, L]] toric code (HGP of two length-L ring repetition codes)."""
    if compute_logicals is None:
        compute_logicals = True
    code = _repetition_product(L, periodic=True, compute_logicals=compute_logicals)
    assert code.checks.num_qubits == 2 * L * L
    return code


def surface_code(L: int, compute_logicals: Optional[bool] = None) -> QuantumCode:
    """[[L^2 + (L-1)^2, 1, L]] unrotated surface code (HGP of two length-L
    path repetition codes)."""
    if compute_logicals is None:
        compute_logicals = True
    code = _repetition_product(L, periodic=False, compute_logicals=compute_logicals)
    assert code.checks.num_qubits == L * L + (L - 1) * (L - 1)
    return code
