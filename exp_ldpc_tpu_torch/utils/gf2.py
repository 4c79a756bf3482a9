"""Bit-packed GF(2) dense linear algebra.

Replaces the `galois` dependency used by the reference
(``reference/python/qldpc/qecc_util.py:10``,
``homological_product_code.py:6-35``, ``linalg.py:93-99``) with a from-scratch
uint64 word-packed implementation: rows are packed 64 columns per word and all
row operations are word-wise XORs, giving a ~64x win over naive byte-wise
elimination.  This is host-side (numpy) code: code construction is one-time
combinatorics and does not benefit from the TPU.

All public functions accept/return plain numpy 0/1 integer arrays (any integer
dtype); packing is internal.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "pack_rows",
    "unpack_rows",
    "row_reduce",
    "row_reduce_packed",
    "rank",
    "null_space",
    "column_space",
    "row_space",
    "get_pivots",
    "matmul_gf2",
]

_WORD = 64


def pack_rows(a: np.ndarray) -> np.ndarray:
    """Pack a 2-D 0/1 array into uint64 words along the column axis (little-endian bit order)."""
    a = np.asarray(a)
    if a.ndim != 2:
        raise ValueError(f"expected 2-D array, got shape {a.shape}")
    bits = (a & 1).astype(np.uint8)
    packed8 = np.packbits(bits, axis=1, bitorder="little")
    pad = (-packed8.shape[1]) % 8
    if pad:
        packed8 = np.pad(packed8, ((0, 0), (0, pad)))
    # little-endian bytes -> little-endian uint64 words (bit k of word w is
    # column 64*w + k), C-speed via packbits
    return np.ascontiguousarray(packed8).view(np.uint64)


def unpack_rows(packed: np.ndarray, ncols: int) -> np.ndarray:
    """Inverse of :func:`pack_rows`; returns a uint8 0/1 array of shape (rows, ncols)."""
    packed = np.ascontiguousarray(packed, dtype=np.uint64)
    bytes_view = packed.view(np.uint8)
    bits = np.unpackbits(bytes_view, axis=1, bitorder="little")
    return bits[:, :ncols]


def _get_bit(packed: np.ndarray, row: int, col: int) -> int:
    return int((packed[row, col // _WORD] >> np.uint64(col % _WORD)) & np.uint64(1))


def _col_bits(packed: np.ndarray, col: int) -> np.ndarray:
    """Return the 0/1 column `col` over all rows of a packed matrix."""
    return ((packed[:, col // _WORD] >> np.uint64(col % _WORD)) & np.uint64(1)).astype(bool)


def row_reduce_packed(packed: np.ndarray, ncols: int, reduce_cols: int | None = None):
    """In-place RREF of a packed matrix over its first `reduce_cols` columns.

    Returns (packed, pivot_cols).  Mirrors the semantics of galois
    ``FieldArray.row_reduce(ncols=...)`` relied on by the reference at
    ``homological_product_code.py:15,32``.  Dispatches to the C++ kernel
    (exp_ldpc_tpu.native) when available; the numpy path below is the
    bit-exact fallback.
    """
    nrows = packed.shape[0]
    if reduce_cols is None:
        reduce_cols = ncols

    from ..native import get_gf2_lib

    lib = get_gf2_lib()
    if lib is not None and nrows > 0:
        packed = np.ascontiguousarray(packed, dtype=np.uint64)
        pivots = np.zeros(min(nrows, reduce_cols) + 1, dtype=np.int64)
        npiv = lib.gf2_row_reduce(
            packed.ctypes.data, nrows, packed.shape[1], reduce_cols, pivots.ctypes.data
        )
        return packed, pivots[:npiv]
    pivot_cols = []
    pr = 0  # pivot row
    for col in range(reduce_cols):
        if pr >= nrows:
            break
        colbits = _col_bits(packed, col)
        # find first row >= pr with a 1 in this column
        cand = np.nonzero(colbits[pr:])[0]
        if cand.size == 0:
            continue
        src = pr + int(cand[0])
        if src != pr:
            packed[[pr, src]] = packed[[src, pr]]
            colbits[[pr, src]] = colbits[[src, pr]]
        # eliminate every other row holding a 1 in this column
        colbits[pr] = False
        if colbits.any():
            packed[colbits] ^= packed[pr]
        pivot_cols.append(col)
        pr += 1
    return packed, np.array(pivot_cols, dtype=np.int64)


def row_reduce(a: np.ndarray, ncols: int | None = None):
    """Reduced row-echelon form of a 0/1 matrix over GF(2).

    If `ncols` is given, only the first `ncols` columns are used to select
    pivots (the remaining columns are carried along), matching galois'
    ``row_reduce(ncols=...)``.  Returns (rref, pivot_cols).
    """
    a = np.asarray(a)
    packed = pack_rows(a)
    packed, pivots = row_reduce_packed(packed, a.shape[1], reduce_cols=ncols)
    return unpack_rows(packed, a.shape[1]), pivots


def get_pivots(a: np.ndarray) -> np.ndarray:
    """Pivot columns of an already row-reduced matrix (reference: ``linalg.py:93-95``)."""
    a = np.asarray(a)
    if a.size == 0:
        return np.array([], dtype=np.int64)
    nz = a != 0
    first = nz.argmax(axis=1)
    has = nz[np.arange(a.shape[0]), first]
    return first[has].astype(np.int64)


def rank(a: np.ndarray) -> int:
    """GF(2) rank (reference: ``linalg.py:98-99``)."""
    a = np.asarray(a)
    if a.size == 0:
        return 0
    packed = pack_rows(a)

    from ..native import get_gf2_lib

    lib = get_gf2_lib()
    if lib is not None:
        packed = np.ascontiguousarray(packed, dtype=np.uint64)
        return int(lib.gf2_rank(packed.ctypes.data, packed.shape[0], packed.shape[1], a.shape[1]))
    _, pivots = row_reduce_packed(packed, a.shape[1])
    return len(pivots)


def null_space(a: np.ndarray) -> np.ndarray:
    """Basis (rows) of the right null space {x : a @ x = 0 mod 2}.

    Matches the role of galois ``null_space`` at
    ``homological_product_code.py:9``.
    """
    a = np.asarray(a)
    nrows, ncols = a.shape
    rref, pivots = row_reduce(a)
    pivot_set = set(int(p) for p in pivots)
    free_cols = np.array([c for c in range(ncols) if c not in pivot_set], dtype=np.int64)
    basis = np.zeros((len(free_cols), ncols), dtype=np.uint8)
    if len(free_cols):
        basis[np.arange(len(free_cols)), free_cols] = 1
        if len(pivots):
            # pivot coordinates: x_pivot = rref[pivot_row, free_col] * x_free
            basis[:, pivots] = rref[np.ix_(np.arange(len(pivots)), free_cols)].T
    return basis


def row_space(a: np.ndarray) -> np.ndarray:
    """Row-reduced basis (rows) of the row space of `a`."""
    rref, pivots = row_reduce(a)
    return rref[: len(pivots)]


def column_space(a: np.ndarray) -> np.ndarray:
    """Row-reduced basis (rows) of the column space of `a`.

    Same convention as galois ``column_space`` used at
    ``homological_product_code.py:10``: each returned row is a vector of
    length ``a.shape[0]``.
    """
    return row_space(np.asarray(a).T)


def matmul_gf2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(a @ b) mod 2 for 0/1 matrices, via packed XOR accumulation."""
    a = np.asarray(a)
    b = np.asarray(b)
    bp = pack_rows(b)  # (k, words)
    out = np.zeros((a.shape[0], bp.shape[1]), dtype=np.uint64)
    for i in range(a.shape[0]):
        sel = np.asarray(a[i]) & 1
        rows = bp[sel.astype(bool)]
        if rows.size:
            out[i] = np.bitwise_xor.reduce(rows, axis=0)
    return unpack_rows(out, b.shape[1])


