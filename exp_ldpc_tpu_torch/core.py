"""Core CSS-code data types.

TPU-native re-design of the reference's core types
(``reference/python/qldpc/qecc_util.py:19-155``): the same frozen,
validated containers (checks as canonical scipy CSR, logicals as dense
read-only arrays) plus a device-oriented addition — every container can hand
out a padded-ELL Tanner-graph view (:mod:`exp_ldpc_tpu.tanner`) that the
JAX/Pallas sampler and decoders consume.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Callable, Iterable, List, Sequence

import numpy as np
from scipy import sparse

__all__ = [
    "GF2",
    "QuantumCodeChecks",
    "QuantumCodeLogicals",
    "QuantumCode",
    "CircuitTargets",
    "NoiseRewriter",
    "StorageSim",
    "make_check_matrix",
    "num_rows",
    "num_cols",
]


class GF2(np.ndarray):
    """Dense GF(2) array: a uint8 ndarray whose ring operations reduce mod 2.

    Public-API parity with the reference's ``GF2 = galois.GF(2)``
    (``reference/python/qldpc/qecc_util.py:10``, re-exported at
    ``__init__.py:9``).  Covers the operations reference code actually uses
    on GF2 arrays — construction from 0/1 data, ``@`` (mod-2 matmul, e.g.
    ``misc/_experiment.py:209``), ``+``/``-`` (XOR), ``*`` (AND), equality,
    stacking — without the galois dependency.  For rank / null-space /
    row-reduce use the bit-packed kernels in :mod:`exp_ldpc_tpu.utils.gf2`
    (``np.linalg`` routines see a plain uint8 array and compute over the
    reals, as they would with any integer ndarray).
    """

    def __new__(cls, data):
        arr = np.asarray(data)
        if arr.dtype == np.bool_:
            arr = arr.astype(np.uint8)
        if not np.issubdtype(arr.dtype, np.integer):
            raise TypeError("GF2 requires integral (or bool) input data")
        return np.mod(arr, 2).astype(np.uint8).view(cls)

    def _binary(self, other, op):
        out = op(np.asarray(self, dtype=np.uint8), np.mod(np.asarray(other), 2).astype(np.uint8))
        return np.mod(out, 2).astype(np.uint8).view(GF2)

    def __add__(self, other):
        return self._binary(other, np.bitwise_xor)

    __radd__ = __add__
    __sub__ = __add__
    __rsub__ = __add__

    def __neg__(self):
        return self

    def __mul__(self, other):
        return self._binary(other, np.bitwise_and)

    __rmul__ = __mul__

    def __matmul__(self, other):
        a = np.asarray(self, dtype=np.int64)
        b = np.mod(np.asarray(other), 2).astype(np.int64)
        return np.mod(a @ b, 2).astype(np.uint8).view(GF2)

    def __rmatmul__(self, other):
        a = np.mod(np.asarray(other), 2).astype(np.int64)
        b = np.asarray(self, dtype=np.int64)
        return np.mod(a @ b, 2).astype(np.uint8).view(GF2)

    # ring ufuncs reduce mod 2 even through numpy's machinery (+=, np.add,
    # np.matmul, np.add.reduce); everything else degrades to a PLAIN ndarray
    # so non-field results never masquerade as GF2
    _RING_UFUNCS = None  # filled below (class body can't see np yet on 3.9)

    def __array_ufunc__(self, ufunc, method, *inputs, out=None, **kwargs):
        ring = GF2._RING_UFUNCS
        is_ring = (ufunc in ring and method == "__call__") or (
            ufunc is np.add and method == "reduce"
        )
        if is_ring:
            args = [np.mod(np.asarray(x, dtype=np.int64), 2) for x in inputs]
            result = np.mod(getattr(ufunc, method)(*args, **kwargs), 2).astype(np.uint8)
            if out:
                o = out[0]
                o[...] = result
                return o
            return result.view(GF2) if isinstance(result, np.ndarray) else GF2(result)
        args = [np.asarray(x) if isinstance(x, GF2) else x for x in inputs]
        if out:
            kwargs["out"] = tuple(
                np.asarray(o) if isinstance(o, GF2) else o for o in out
            )
        return getattr(ufunc, method)(*args, **kwargs)


GF2._RING_UFUNCS = frozenset(
    {np.add, np.subtract, np.multiply, np.matmul, np.negative, np.positive}
)


def _check_integral(matrix) -> None:
    # reference: qecc_util.py:12-17
    if not np.issubdtype(matrix.dtype, np.integer):
        raise TypeError("Got numpy object with non-integral dtype")
    if np.issubdtype(matrix.dtype, np.signedinteger):
        warnings.warn(
            "Got numpy object with signed integer datatype. "
            "This could cause problems due when overflowing"
        )


def _canonical_csr(m: sparse.spmatrix) -> sparse.csr_matrix:
    m = m.tocsr()
    m.sort_indices()
    m.sum_duplicates()
    m.prune()
    m.data.flags.writeable = False
    return m


@dataclass(frozen=True)
class QuantumCodeChecks:
    """Frozen pair of X/Z check matrices (CSR, canonicalized, read-only).

    Behavioral parity with ``qecc_util.py:19-51``.
    """

    x: sparse.csr_matrix
    z: sparse.csr_matrix

    def __init__(self, x: sparse.spmatrix, z: sparse.spmatrix):
        object.__setattr__(self, "x", _canonical_csr(x))
        object.__setattr__(self, "z", _canonical_csr(z))
        _check_integral(self.x)
        _check_integral(self.z)
        if self.x.shape[1] != self.z.shape[1]:
            raise ValueError("x and z checks act on an inconsistent number of qubits")

    @property
    def num_qubits(self) -> int:
        return self.x.shape[1]


@dataclass(frozen=True)
class QuantumCodeLogicals:
    """Dense logical-operator matrices with read-only buffers (``qecc_util.py:53-91``)."""

    x: np.ndarray
    z: np.ndarray

    def __post_init__(self):
        self.x.flags.writeable = False
        self.z.flags.writeable = False
        _check_integral(self.x)
        _check_integral(self.z)
        if self.x.shape[1] != self.z.shape[1]:
            raise ValueError("x and z logicals act on an inconsistent number of qubits")
        if self.x.shape[0] != self.z.shape[0]:
            raise ValueError("Number of provided X and Z logical operators mismatch")
        if type(self.x) is not np.ndarray or type(self.z) is not np.ndarray:
            warnings.warn(
                "Attempting to create QuantumCodeLogicals with something that is not "
                f"a numpy array. Got: {type(self.x)=} and {type(self.z)=}"
            )

    @property
    def num_qubits(self) -> int:
        return self.x.shape[1]

    @property
    def num_logicals(self) -> int:
        return self.x.shape[0]

    @staticmethod
    def empty(num_qubits: int) -> "QuantumCodeLogicals":
        return QuantumCodeLogicals(
            np.zeros((0, num_qubits), dtype=np.uint32),
            np.zeros((0, num_qubits), dtype=np.uint32),
        )


@dataclass(frozen=True)
class QuantumCode:
    """A CSS code = (checks, logicals) (``qecc_util.py:94-118``).

    ``qc_meta`` optionally records block-circulant structure
    (:class:`exp_ldpc_tpu.codes.qc_meta.BlockCirculantMeta`) so the decoder
    factory can route quasi-cyclic families to the roll-based BP kernel; it
    is not part of the reference API surface and defaults to ``None``.
    """

    checks: QuantumCodeChecks
    logicals: QuantumCodeLogicals

    def __init__(self, checks: QuantumCodeChecks, logicals: QuantumCodeLogicals = None,
                 qc_meta=None):
        if logicals is None:
            logicals = QuantumCodeLogicals.empty(checks.num_qubits)
        if checks.num_qubits != logicals.num_qubits:
            raise ValueError("Number of qubits for checks and logicals is inconsistent")
        object.__setattr__(self, "checks", checks)
        object.__setattr__(self, "logicals", logicals)
        object.__setattr__(self, "qc_meta", qc_meta)

    @property
    def num_qubits(self) -> int:
        return self.checks.num_qubits

    @property
    def num_logicals(self) -> int:
        return self.logicals.num_logicals


@dataclass(frozen=True)
class CircuitTargets:
    """Qubit-index layout of a syndrome-extraction circuit (``qecc_util.py:120-131``)."""

    data: List[int]
    x_checks: List[int]
    z_checks: List[int]
    ancillas: List[int]

    def __init__(self, data: List[int], x_checks: List[int], z_checks: List[int]):
        object.__setattr__(self, "data", data)
        object.__setattr__(self, "x_checks", x_checks)
        object.__setattr__(self, "z_checks", z_checks)
        object.__setattr__(self, "ancillas", list(x_checks) + list(z_checks))


@dataclass(frozen=True)
class NoiseRewriter:
    """Wraps a circuit-rewriting pass (``qecc_util.py:134-136``)."""

    rewrite: Callable[[CircuitTargets, Iterable[str]], Iterable[str]]


@dataclass(frozen=True)
class StorageSim:
    """Circuit text plus measurement-record index views (``qecc_util.py:151-155``)."""

    circuit: Sequence[str]
    measurement_view: Callable
    data_view: Callable


def num_rows(a) -> int:
    assert len(a.shape) == 2
    return a.shape[0]


def num_cols(a) -> int:
    assert len(a.shape) == 2
    return a.shape[1]


def make_check_matrix(checks: Iterable[Iterable[int]], num_qubits) -> sparse.csr_matrix:
    """Support lists -> CSR check matrix (``qecc_util.py:146-149``)."""
    checks = list(checks)
    rows, cols = [], []
    for i, support in enumerate(checks):
        for v in support:
            rows.append(i)
            cols.append(v)
    return sparse.csr_matrix(
        (np.ones(len(rows), dtype=np.uint32), (rows, cols)),
        shape=(len(checks), num_qubits),
        dtype=np.uint32,
    )
