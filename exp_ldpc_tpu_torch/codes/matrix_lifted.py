"""Group-algebra lifted product codes.

Behavioral parity with ``reference/python/qldpc/
matrix_lifted_product_code.py``: base matrices over the group algebra F2[G]
are lifted to binary check matrices through regular permutation
representations — the LEFT regular representation for the A-tensor blocks
and the RIGHT regular representation for the B-tensor blocks (reference
``:189-197``), which is what makes the two boundary maps commute for
non-abelian G.
"""
from __future__ import annotations

from copy import deepcopy
from typing import Dict, List, Optional

import numpy as np
import scipy.sparse as sparse

from ..core import QuantumCode, QuantumCodeChecks
from .homological import get_logicals
from .lifted import Group

__all__ = [
    "GroupAlgebra",
    "group_algebra_zero",
    "group_algebra_monomial",
    "RegularRep",
    "matrix_lifted_product_code",
]


class GroupAlgebra:
    """An element of F2[G]: a dict {group element: coefficient in GF(2)}.

    The reference supports arbitrary scalar fields (``:14-57``); everything
    this framework lifts is over F2, so coefficients are Python ints mod 2.
    """

    def __init__(self, data: Dict[Group, int]):
        self._data = {g: c % 2 for g, c in data.items() if c % 2}

    def __mul__(self, other):
        if isinstance(other, GroupAlgebra):
            out: Dict[Group, int] = {}
            for a, u in self._data.items():
                for b, v in other._data.items():
                    c = a @ b
                    out[c] = out.get(c, 0) + u * v
            return GroupAlgebra(out)
        return GroupAlgebra({a: u * int(other) for a, u in self._data.items()})

    __rmul__ = __mul__

    def __add__(self, other: "GroupAlgebra") -> "GroupAlgebra":
        keys = set(self._data) | set(other._data)
        return GroupAlgebra({k: self._data.get(k, 0) + other._data.get(k, 0) for k in keys})

    def antipode(self) -> "GroupAlgebra":
        """Basis elements map to their inverses (``:47-49``)."""
        return GroupAlgebra({a.inv(): u for a, u in self._data.items()})

    def terms(self) -> Dict[Group, int]:
        return dict(self._data)

    def __eq__(self, other):
        return isinstance(other, GroupAlgebra) and self._data == other._data

    def __repr__(self):
        return f"GroupAlgebra({self._data})"


def group_algebra_zero(*_args) -> GroupAlgebra:
    return GroupAlgebra({})


def group_algebra_monomial(scale, element: Group) -> GroupAlgebra:
    """scale * element as a group-algebra element.  `scale` may be the
    reference's GF2 scalar or a plain int."""
    return GroupAlgebra({element: int(scale)})


class RegularRep:
    """Memoized left/right regular permutation representation (``:66-103``)."""

    def __init__(self, group, right_action: Optional[bool] = None):
        self._group = list(group)
        self._index = {g: i for i, g in enumerate(self._group)}
        self._right_action = bool(right_action) if right_action is not None else False
        self._matrices: Dict[Group, np.ndarray] = {}

    def zero(self) -> np.ndarray:
        n = len(self._group)
        return np.zeros((n, n), dtype=np.uint8)

    def get_rep(self, element: Group) -> np.ndarray:
        if element not in self._matrices:
            mat = self.zero()
            for g in self._group:
                h = g @ element if self._right_action else element @ g
                mat[self._index[h], self._index[g]] = 1
            self._matrices[element] = mat
        return self._matrices[element]


def matrix_lifted_product_code(
    group,
    base_matrix_A,
    base_matrix_B=None,
    dual_A=None,
    dual_B=None,
    check_complex=None,
    compute_logicals=None,
) -> QuantumCode:
    """Lifted product of base matrices over F2[G] (reference ``:105-212``).

    A: A1 -> A0 and B: B1 -> B0 are length-1 complexes; B defaults to A*
    (transpose + antipode).  ``dual_A`` / ``dual_B`` apply the dual map to the
    given matrices.
    """
    if check_complex is None:
        check_complex = False
    if compute_logicals is None:
        compute_logicals = False
    if base_matrix_B is None:
        assert dual_A is None and dual_B is None
    if dual_A is None:
        dual_A = False
    if dual_B is None:
        dual_B = False

    def dual(a):
        return np.vectorize(lambda x: x.antipode())(np.transpose(a))

    partial_A = np.array(base_matrix_A, dtype=object)
    partial_B = np.array(base_matrix_B, dtype=object) if base_matrix_B is not None else dual(partial_A)
    if dual_A:
        partial_A = dual(partial_A)
    if dual_B:
        partial_B = dual(partial_B)

    group = list(group)
    left_rep = RegularRep(group)
    right_rep = RegularRep(group, right_action=True)
    ga_one = group_algebra_monomial(1, group[0].identity())

    def identity(size):
        out = np.empty((size, size), dtype=object)
        for i in range(size):
            for j in range(size):
                out[i, j] = ga_one if i == j else group_algebra_zero()
        return out

    def kron_obj(a, b):
        ra, ca = a.shape
        rb, cb = b.shape
        out = np.empty((ra * rb, ca * cb), dtype=object)
        for i in range(ra):
            for j in range(ca):
                for k in range(rb):
                    for m in range(cb):
                        out[i * rb + k, j * cb + m] = a[i, j] * b[k, m]
        return out

    def embed_binary(a, rep: RegularRep):
        n = len(group)
        r, c = a.shape
        out = np.zeros((r * n, c * n), dtype=np.uint8)
        for i in range(r):
            for j in range(c):
                acc = None
                for g, coeff in a[i, j].terms().items():
                    block = rep.get_rep(g)
                    acc = block.copy() if acc is None else (acc ^ block)
                if acc is not None:
                    out[i * n : (i + 1) * n, j * n : (j + 1) * n] = acc
        return out

    partial_2 = np.vstack(
        [
            embed_binary(kron_obj(partial_A, identity(partial_B.shape[1])), left_rep),
            embed_binary(kron_obj(identity(partial_A.shape[1]), partial_B), right_rep),
        ]
    )
    partial_1 = np.hstack(
        [
            embed_binary(kron_obj(identity(partial_A.shape[0]), partial_B), right_rep),
            embed_binary(kron_obj(partial_A, identity(partial_B.shape[0])), left_rep),
        ]
    )

    if check_complex:
        prod = (partial_1.astype(np.float32) @ partial_2.astype(np.float32)) % 2
        assert not prod.any()

    checks = QuantumCodeChecks(
        sparse.csc_matrix(partial_2).transpose().astype(np.uint32),
        sparse.csr_matrix(partial_1).astype(np.uint32),
    )
    logicals = get_logicals(checks, compute_logicals, check_complex)
    code = QuantumCode(checks, logicals)
    assert len(logicals.x) == len(logicals.z)
    assert checks.x.shape == checks.z.shape
    return code
