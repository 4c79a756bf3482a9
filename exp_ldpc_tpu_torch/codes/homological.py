"""Homological products of 2-complexes and logical-operator extraction.

Behavioral parity with ``reference/python/qldpc/
homological_product_code.py`` (same inputs, same code parameters, a valid
symplectically-paired logical basis) with a different construction:

  * homology representatives come from *reducing the kernel modulo the
    image* — image pivots are eliminated from every kernel vector in one
    vectorized XOR sweep, and the independent residuals are the
    representatives — rather than the reference's augmented
    ``[image^T | kernel^T]`` pivot-column basis extension
    (``homological_product_code.py:6-21``);
  * the symplectic re-pairing inverts the pairing matrix explicitly over
    GF(2) and applies it with a bit-packed matmul, rather than the
    reference's augmented row-reduction (``homological_product_code.py:
    23-35``);
  * both homology sectors share one dense conversion and run through one
    sector loop.

All dense GF(2) work runs on the bit-packed word-parallel kernels in
:mod:`exp_ldpc_tpu.utils.gf2` — the O(n^3) homology (the reference's
acknowledged scaling wall, ``scripts/generate_hgp_code.py:19``) becomes
O(n^3/64) word ops.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sparse

from ..core import QuantumCode, QuantumCodeChecks, QuantumCodeLogicals
from ..utils import gf2

__all__ = [
    "homological_product",
    "get_logicals",
    "quotient_representatives",
    "symplectic_repair",
]


def quotient_representatives(boundary: np.ndarray, cocycle_map: np.ndarray) -> np.ndarray:
    """Basis of H = ker(cocycle_map) / im(boundary), by residual reduction.

    Every vector of ker(cocycle_map) is reduced modulo im(boundary): for each
    pivot column of the row-reduced image basis, the matching image row is
    XORed into every kernel vector with a 1 in that column (one vectorized
    sweep per pivot).  The residuals lie in a complement of the image inside
    the kernel; row-reducing them and keeping the nonzero rows yields exactly
    dim(ker) - dim(im) independent representatives.

    Behavioral counterpart of ``homological_product_code.py:6-21``; the
    returned representatives differ from the reference's (any coset basis is
    valid) but span the same homology classes.
    """
    kernel = gf2.null_space(cocycle_map).astype(np.uint8)
    if kernel.shape[0] == 0:
        return kernel
    image = gf2.column_space(boundary).astype(np.uint8)  # row-reduced span
    if image.shape[0]:
        for img_row, piv in zip(image, gf2.get_pivots(image)):
            hit = kernel[:, piv].astype(bool)
            kernel[hit] ^= img_row
    residual, _ = gf2.row_reduce(kernel)
    keep = residual.any(axis=1)
    return np.ascontiguousarray(residual[keep])


def symplectic_repair(z_logicals: np.ndarray, x_logicals: np.ndarray) -> np.ndarray:
    """Re-basis the Z logicals so that ``L_z @ L_x^T = I`` over GF(2).

    Computes the pairing matrix ``P = L_z L_x^T`` with a bit-packed matmul,
    inverts it by row-reducing ``[P | I]``, and returns ``P^{-1} L_z``.
    ``P`` is square and invertible whenever the X/Z homology sectors are dual
    (guaranteed for the products built here).  Behavioral counterpart of
    ``homological_product_code.py:23-35``.
    """
    k = z_logicals.shape[0]
    if k == 0:
        return z_logicals
    pairing = gf2.matmul_gf2(z_logicals, x_logicals.T)
    assert pairing.shape == (k, k)
    aug, _ = gf2.row_reduce(np.hstack([pairing, np.eye(k, dtype=np.uint8)]), ncols=k)
    assert np.array_equal(aug[:, :k], np.eye(k, dtype=aug.dtype)), (
        "symplectic pairing is degenerate — X/Z homology sectors are not dual"
    )
    inverse = aug[:, k:]
    return gf2.matmul_gf2(inverse, z_logicals)


def get_logicals(
    checks: QuantumCodeChecks, compute_logicals: bool, check_complex: bool
) -> QuantumCodeLogicals:
    """X/Z logical operators of a CSS code.

    Behavioral counterpart of ``homological_product_code.py:37-60``: X
    logicals span H_1 = ker(d_z) / im(d_x^T), Z logicals span the dual
    H^1 = ker(d_x) / im(d_z^T), re-paired so L_z @ L_x^T = I.
    """
    n = checks.z.shape[1]
    x_logicals = np.zeros((0, n), dtype=np.uint32)
    z_logicals = np.zeros((0, n), dtype=np.uint32)
    if compute_logicals:
        dx = (checks.x.toarray() % 2).astype(np.uint8)
        dz = (checks.z.toarray() % 2).astype(np.uint8)
        # (boundary whose image is modded out, map whose kernel is taken)
        sectors: Tuple[Tuple[np.ndarray, np.ndarray], ...] = ((dx.T, dz), (dz.T, dx))
        x_logicals, z_logicals = (
            quotient_representatives(boundary, cocycle) for boundary, cocycle in sectors
        )
        z_logicals = symplectic_repair(z_logicals, x_logicals)

        if check_complex:
            assert not np.any(gf2.matmul_gf2(dz, x_logicals.T)), "X logicals not in ker(d_z)"
            assert not np.any(gf2.matmul_gf2(dx, z_logicals.T)), "Z logicals not in ker(d_x)"
            assert x_logicals.shape[0] + gf2.rank(dz) + gf2.rank(dx) == n
    return QuantumCodeLogicals(
        np.ascontiguousarray(x_logicals, dtype=np.uint32),
        np.ascontiguousarray(z_logicals, dtype=np.uint32),
    )


def _product_boundaries(
    partial_A: sparse.csr_matrix, partial_B: sparse.csr_matrix
) -> Tuple[sparse.csr_matrix, sparse.csr_matrix]:
    """Boundary maps of the total complex of (A ⊗ B):

      partial_2 = [A ⊗ I ; I ⊗ B],  partial_1 = [I ⊗ B | A ⊗ I]

    (standard homological product; reference ``homological_product_code.py:
    64-103`` builds the same maps).  Entries are reduced mod 2 in case the
    factors carry duplicate entries.
    """
    eye = lambda m: sparse.identity(m, dtype=np.int8)
    partial_2 = sparse.vstack(
        [sparse.kron(partial_A, eye(partial_B.shape[1])),
         sparse.kron(eye(partial_A.shape[1]), partial_B)]
    ).tocsr()
    partial_1 = sparse.hstack(
        [sparse.kron(eye(partial_A.shape[0]), partial_B),
         sparse.kron(partial_A, eye(partial_B.shape[0]))]
    ).tocsr()
    for m in (partial_2, partial_1):
        m.data = m.data.astype(np.int8) % 2
        m.eliminate_zeros()
    return partial_2, partial_1


def homological_product(
    partial_A: sparse.spmatrix,
    partial_B: sparse.spmatrix,
    check_complex: Optional[bool] = None,
    compute_logicals: Optional[bool] = None,
) -> QuantumCode:
    """Product of two 2-complexes given by their boundary maps.

    Behavioral parity with ``homological_product_code.py:64-103``; the
    boundary assembly lives in :func:`_product_boundaries` and the logical
    extraction in :func:`get_logicals`.
    """
    check_complex = bool(check_complex)
    compute_logicals = bool(compute_logicals)

    partial_A = sparse.csr_matrix(partial_A)
    partial_B = sparse.csr_matrix(partial_B)
    partial_2, partial_1 = _product_boundaries(partial_A, partial_B)

    num_1cells = partial_A.shape[0] * partial_B.shape[1] + partial_A.shape[1] * partial_B.shape[0]
    assert partial_2.shape == (num_1cells, partial_A.shape[1] * partial_B.shape[1])
    assert partial_1.shape == (partial_A.shape[0] * partial_B.shape[0], num_1cells)
    if check_complex:
        assert np.all((partial_1 @ partial_2).data % 2 == 0)

    checks = QuantumCodeChecks(
        partial_2.tocsc().transpose().astype(np.uint32), partial_1.astype(np.uint32)
    )
    logicals = get_logicals(checks, compute_logicals, check_complex)
    assert logicals.x.shape[0] == logicals.z.shape[0]
    return QuantumCode(checks, logicals)
