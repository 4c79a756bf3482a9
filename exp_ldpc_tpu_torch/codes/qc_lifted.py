"""Quasicyclic lifted product codes (Panteleev–Kalachev, arXiv:2012.04068).

Behavioral parity with ``reference/python/qldpc/qc_lifted_product_code.py``
without galois: elements of GF2[x]/(x^l - 1) are coefficient vectors, a
"polynomial matrix" is a (rows, cols, l) uint8 array, the Kronecker product
is a cyclic convolution of entries, and the binary embedding maps each entry
to its l x l circulant block.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sparse

from ..core import QuantumCode, QuantumCodeChecks
from .homological import get_logicals
from .qc_meta import BlockCirculantMeta

__all__ = ["qc_lifted_product_code", "shifts_to_poly_matrix"]


def shifts_to_poly_matrix(shifts: np.ndarray, l: int) -> np.ndarray:
    """Integer shift matrix -> (r, c, l) coefficient array with entry x^k."""
    shifts = np.asarray(shifts)
    out = np.zeros(shifts.shape + (l,), dtype=np.uint8)
    r_idx, c_idx = np.indices(shifts.shape)
    out[r_idx.ravel(), c_idx.ravel(), (shifts % l).ravel()] = 1
    return out


def _poly_identity(size: int, l: int) -> np.ndarray:
    out = np.zeros((size, size, l), dtype=np.uint8)
    for i in range(size):
        out[i, i, 0] = 1
    return out


def _antipode(pm: np.ndarray) -> np.ndarray:
    """x^k -> x^{(l-k) mod l} entrywise: reverse the nonconstant coefficients."""
    out = np.zeros_like(pm)
    out[..., 0] = pm[..., 0]
    out[..., 1:] = pm[..., :0:-1]
    return out


def _poly_kron(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Kronecker product of polynomial matrices: entries multiply by cyclic
    convolution mod 2."""
    ra, ca, l = a.shape
    rb, cb, _ = b.shape
    # conv[i,j,k,m,t] = sum_{u+v = t mod l} a[i,j,u] b[k,m,v]
    av = a.astype(np.int64)
    bv = b.astype(np.int64)
    out = np.zeros((ra, ca, rb, cb, l), dtype=np.int64)
    for u in range(l):
        au = av[:, :, u]
        if not au.any():
            continue
        rolled = np.roll(bv, u, axis=2)  # b shifted: coefficient v -> u+v
        out += au[:, :, None, None, None] * rolled[None, None, :, :, :]
    out = (out % 2).astype(np.uint8)
    # reorder to ((i,k),(j,m),l)
    return out.transpose(0, 2, 1, 3, 4).reshape(ra * rb, ca * cb, l)


def _poly_vstack(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.concatenate([a, b], axis=0)


def _poly_hstack(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.concatenate([a, b], axis=1)


def _embed_binary(pm: np.ndarray) -> np.ndarray:
    """(r, c, l) polynomial matrix -> (r*l, c*l) binary with circulant blocks
    C[u, v] = coeff[(u - v) mod l]."""
    r, c, l = pm.shape
    u = np.arange(l)
    idx = (u[:, None] - u[None, :]) % l  # (l, l)
    blocks = pm[:, :, idx]  # (r, c, l, l)
    return blocks.transpose(0, 2, 1, 3).reshape(r * l, c * l)


def qc_lifted_product_code(
    quasicyclic_check_matrix,
    l: int,
    check_complex: Optional[bool] = None,
    compute_logicals: Optional[bool] = None,
) -> QuantumCode:
    """QC-LP from an n x m matrix over GF2[x]/(x^l - 1).

    Integer input is interpreted as shifts (entry k -> x^k), matching the
    reference (``qc_lifted_product_code.py:16-23``).  partial_B is the
    antipode of partial_A^T; the product complex follows
    ``homological_product`` block structure and the binary embedding uses
    circulant blocks.
    """
    if check_complex is None:
        check_complex = False
    if compute_logicals is None:
        compute_logicals = False

    qc = np.asarray(quasicyclic_check_matrix)
    if qc.ndim == 2:
        partial_A = shifts_to_poly_matrix(qc, l)
    else:
        partial_A = qc.astype(np.uint8)
        assert partial_A.shape[2] == l

    partial_B = _antipode(partial_A.transpose(1, 0, 2))

    partial_2 = _embed_binary(
        _poly_vstack(
            _poly_kron(partial_A, _poly_identity(partial_B.shape[1], l)),
            _poly_kron(_poly_identity(partial_A.shape[1], l), partial_B),
        )
    )
    partial_1 = _embed_binary(
        _poly_hstack(
            _poly_kron(_poly_identity(partial_A.shape[0], l), partial_B),
            _poly_kron(partial_A, _poly_identity(partial_B.shape[0], l)),
        )
    )

    if check_complex:
        prod = (partial_1.astype(np.float32) @ partial_2.astype(np.float32)) % 2
        assert not prod.any()

    checks = QuantumCodeChecks(
        sparse.csc_matrix(partial_2).transpose().astype(np.uint32),
        sparse.csr_matrix(partial_1).astype(np.uint32),
    )
    logicals = get_logicals(checks, compute_logicals, check_complex)
    # _embed_binary emits circulant l x l blocks directly: natively QC
    code = QuantumCode(checks, logicals, qc_meta=BlockCirculantMeta(dims=(l,)))
    assert len(logicals.x) == len(logicals.z)
    assert checks.x.shape == checks.z.shape
    return code
