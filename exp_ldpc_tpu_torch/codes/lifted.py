"""Group-theoretic lifted product codes.

Behavioral parity with ``reference/python/qldpc/lifted_product_code.py``
on our own foundations: group elements are small immutable objects over the
table-based fields in :mod:`exp_ldpc_tpu.utils.fields` (no galois), and the
Tanner-code lifted product assembles its boundary maps through mixed-radix
index arithmetic over (edge, group, vertex, row) tuples instead of the
reference's dict-of-typed-keys bookkeeping — same complex, O(1) index math.

Constructions:
  * :class:`GL2` / :class:`PGL2` matrix groups over GF(q) with canonical
    projective representatives (reference ``:47-104``);
  * :class:`Zqm` abelian groups and random generator sets (``:106-162``);
  * Morgenstern generators for PGL(2, q^i), q = 2^l, following Dinur et al.
    2021 arXiv:2111.04808 (``:164-203``) — the subfield GF(q) inside
    GF(q^i) is found exactly as {x : x^q = x} rather than by integer-code
    coincidence;
  * brute-force PSL(2, q) enumeration (``:205-212``);
  * group closure by DFS (``:214-234``);
  * the Tanner-code lifted product over a base graph (double cover B_w or
    bouquet D_w) with local systems h1, h2 (``:264-409``).
"""
from __future__ import annotations

import warnings
from abc import ABC, abstractmethod
from dataclasses import dataclass
from itertools import product
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import scipy.sparse as sparse

from ..core import QuantumCode, QuantumCodeChecks
from ..utils.fields import GF, FiniteField
from .homological import get_logicals
from .random_code import random_check_matrix

__all__ = [
    "Group",
    "GL2",
    "PGL2",
    "Zqm",
    "random_abelian_generators",
    "morgenstern_generators",
    "get_psl2",
    "dfs_generators",
    "lifted_product_code",
    "lifted_product_code_cyclic",
    "lifted_product_code_pgl2",
    "BaseGraph",
]


class Group(ABC):
    """Minimal group-element interface (reference ``:20-44``)."""

    @abstractmethod
    def __matmul__(self, other: "Group") -> "Group": ...

    @abstractmethod
    def inv(self) -> "Group": ...

    @abstractmethod
    def identity(self) -> "Group": ...

    @abstractmethod
    def __hash__(self): ...

    def __pow__(self, n: int) -> "Group":
        assert isinstance(n, int) and n >= 0
        r = self.identity()
        base = self
        while n:
            if n & 1:
                r = r @ base
            base = base @ base
            n >>= 1
        return r


class GL2(Group):
    """GL(2, q) with entries as integer field codes."""

    __slots__ = ("field", "data")

    def __init__(self, field: FiniteField, data):
        self.field = field
        self.data = tuple(tuple(int(x) for x in row) for row in data)

    def __matmul__(self, other: "GL2") -> "GL2":
        return type(self)(self.field, self.field.mat2_mul(self.data, other.data))

    def inv(self) -> "GL2":
        return type(self)(self.field, self.field.mat2_inv(self.data))

    def identity(self) -> "GL2":
        return type(self)(self.field, ((1, 0), (0, 1)))

    def det(self) -> int:
        return self.field.mat2_det(self.data)

    def __hash__(self):
        return hash((self.field.order, self.data))

    def __eq__(self, other):
        return self.field.order == other.field.order and self.data == other.data

    def __repr__(self):
        return f"GL2({self.field.order}, {self.data})"


class PGL2(GL2):
    """PGL(2, q): GL2 cosets canonicalized by scaling the first nonzero entry
    of the top row to 1 (reference ``:80-104``)."""

    def __init__(self, field: FiniteField, data, canonicalized: bool = False):
        super().__init__(field, data)
        if not canonicalized:
            (a, b), _ = self.data
            pivot = a if a != 0 else b
            scale = int(field.inv(pivot))
            self.data = tuple(
                tuple(int(field.mul(scale, x)) for x in row) for row in self.data
            )

    def identity(self) -> "PGL2":
        return type(self)(self.field, ((1, 0), (0, 1)), canonicalized=True)


class Zqm(Group):
    """The abelian group Z_q^m (reference ``:106-140``, with its always-true
    ``__eq__`` comparison bug fixed — SURVEY.md §2.5.4)."""

    __slots__ = ("q", "m", "data")

    def __init__(self, q: int, m: int, data):
        data = tuple(int(x) % q for x in np.atleast_1d(np.asarray(data)))
        assert len(data) == m
        self.q = q
        self.m = m
        self.data = data

    def __matmul__(self, other: "Zqm") -> "Zqm":
        assert self.q == other.q and self.m == other.m
        return Zqm(self.q, self.m, [a + b for a, b in zip(self.data, other.data)])

    def inv(self) -> "Zqm":
        return Zqm(self.q, self.m, [self.q - a for a in self.data])

    def identity(self) -> "Zqm":
        return Zqm(self.q, self.m, [0] * self.m)

    def __hash__(self):
        return hash((self.q, self.m, self.data))

    def __eq__(self, other):
        return self.q == other.q and self.m == other.m and self.data == other.data

    def __repr__(self):
        return f"Zqm({self.q}, {self.data})"


def random_abelian_generators(q, m, k, symmetric=None, seed=None) -> List[Zqm]:
    """k random generators for Z_q^m; if symmetric, k/2 generators plus their
    inverses (reference ``:142-162``)."""
    rng = np.random.default_rng(seed)
    if symmetric is None:
        symmetric = False
    symmetrize = symmetric and q != 2
    if symmetrize:
        if k % 2 != 0:
            raise ValueError(
                "symmetrized generator sets over q != 2 need an even generator count"
            )
        k = k // 2
    matrix = rng.integers(low=0, high=q, size=(k, m))
    generators = [Zqm(q, m, matrix[i]) for i in range(k)]
    if symmetrize:
        generators = [h for g in generators for h in (g, g.inv())]
    return generators


def morgenstern_generators(l, i, use_B_generators=None, symmetric=None) -> List[PGL2]:
    """Morgenstern generators for PGL(2, q^i), q = 2^l (Dinur et al. 2021).

    |A| = q + 1; the optional B set is {ab : a != b in A} (reference
    ``:164-203``)."""
    if symmetric is None:
        symmetric = True
    if use_B_generators is None:
        use_B_generators = False
    assert l >= 1
    if i % 2 != 0:
        raise ValueError(
            "Morgenstern generators exist only for PGL(2, q^i) with even i "
            "(the required quaternion algebra has no odd-i analog)"
        )
    q = 2**l
    Fqi = GF(q**i)
    sub = Fqi.subfield_elements(q)  # the genuine GF(q) inside GF(q^i)
    sub_set = set(sub)

    # i_element outside GF(q) with i^2 + i inside GF(q)
    i_element = next(
        x
        for x in Fqi.elements
        if x not in sub_set and int(Fqi.add(Fqi.mul(x, x), x)) in sub_set
    )
    eps = int(Fqi.add(Fqi.mul(i_element, i_element), i_element))

    # solutions of g^2 + g d + d^2 eps = 1 over GF(q); exactly q+1 exist
    pairs = [
        (g, d)
        for g in sub
        for d in sub
        if int(
            Fqi.add(
                Fqi.add(Fqi.mul(g, g), Fqi.mul(g, d)),
                Fqi.mul(Fqi.mul(d, d), eps),
            )
        )
        == 1
    ]
    assert len(pairs) == q + 1
    x = Fqi.primitive_element
    generators = [
        PGL2(
            Fqi,
            (
                (1, int(Fqi.add(g, Fqi.mul(d, i_element)))),
                (int(Fqi.mul(x, Fqi.add(Fqi.add(g, d), Fqi.mul(d, i_element)))), 1),
            ),
        )
        for (g, d) in pairs
    ]
    if use_B_generators:
        generators = [
            a @ b
            for ia, a in enumerate(generators)
            for ib, b in enumerate(generators)
            if ia != ib and (ia < ib or symmetric)
        ]
    return generators


def get_psl2(q) -> frozenset:
    """All elements of PSL(2, q) as canonical PGL2 representatives, O(q^4)
    (reference ``:205-212``)."""
    F = GF(q)
    out = set()
    for a in F.elements:
        for b in F.elements:
            for c in F.elements:
                for d in F.elements:
                    m = GL2(F, ((a, b), (c, d)))
                    if m.det() == 1:
                        out.add(PGL2(F, m.data))
    return frozenset(out)


def dfs_generators(root: Group, generators: Sequence[Group], traverse=None) -> Set[Group]:
    """Closure of `generators` acting from the left on `root` (reference
    ``:214-234``)."""
    if traverse is None:
        traverse = lambda a, b: a @ b
    visited: Set[Group] = set()
    frontier = [root]
    while frontier:
        leaf = frontier.pop()
        if leaf in visited:
            continue
        visited.add(leaf)
        frontier.extend(traverse(leaf, g) for g in generators)
    return visited


# backwards-compatible alias matching the reference's private name
_dfs_generators = dfs_generators


@dataclass
class BaseGraph:
    """Regular directed multigraph with generator-labelled edges.

    Edges are (tail, head, generator); per-vertex local-system column
    indices: out-edges first, then in-edges (matching the reference's
    ``out_idx`` / ``in_idx`` convention, ``:307-314``).
    """

    num_vertices: int
    edges: List[Tuple[int, int, Group]]

    def __post_init__(self):
        self.out_edges: List[List[int]] = [[] for _ in range(self.num_vertices)]
        self.in_edges: List[List[int]] = [[] for _ in range(self.num_vertices)]
        for eid, (u, v, _g) in enumerate(self.edges):
            self.out_edges[u].append(eid)
            self.in_edges[v].append(eid)
        # local-system column index of edge e at vertex v
        self.out_col: List[Dict[int, int]] = []
        self.in_col: List[Dict[int, int]] = []
        for v in range(self.num_vertices):
            oc = {e: i for i, e in enumerate(self.out_edges[v])}
            ic = {e: i + len(oc) for i, e in enumerate(self.in_edges[v])}
            self.out_col.append(oc)
            self.in_col.append(ic)

    @property
    def num_edges(self) -> int:
        return len(self.edges)

    def degree(self, v: int) -> int:
        return len(self.out_edges[v]) + len(self.in_edges[v])

    @classmethod
    def double_cover(cls, generators: Sequence[Group]) -> "BaseGraph":
        """B_w: two vertices, one edge 0->1 per generator."""
        return cls(2, [(0, 1, g) for g in generators])

    @classmethod
    def bouquet(cls, generators: Sequence[Group]) -> "BaseGraph":
        """D_w: one vertex, one self-loop per generator."""
        return cls(1, [(0, 0, g) for g in generators])


def lifted_product_code(
    group,
    generators,
    h1,
    h2,
    check_complex=None,
    compute_logicals=None,
    double_cover=None,
    base_graph: Optional[BaseGraph] = None,
) -> QuantumCode:
    """Tanner-code lifted product E x V -> ExE + VxV -> V x E.

    `h1`, `h2` are the local systems (0/1 matrices, one column per incident
    edge slot of a base-graph vertex); the left factor's group action is from
    the left and the right factor's from the right (reference ``:264-409``).

    Index spaces are flat mixed-radix products:
      X checks:  (e1, g, v2, r2)
      qubits:    block EE = (e1, g, e2);  block VV = (v1, r1, g, v2, r2)
      Z checks:  (v1, r1, g, e2)
    """
    warnings.warn("lifted-product construction is an experimental surface")
    if check_complex is None:
        check_complex = False
    if compute_logicals is None:
        compute_logicals = False
    if double_cover is None:
        double_cover = True

    h1 = np.asarray(h1) % 2
    h2 = np.asarray(h2) % 2
    if h1.shape[1] != h2.shape[1]:
        raise ValueError("h1 and h2 need equal block lengths (mixed lengths unsupported)")

    if base_graph is None:
        base_graph = (
            BaseGraph.double_cover(generators) if double_cover else BaseGraph.bouquet(generators)
        )
    B = base_graph
    for v in range(B.num_vertices):
        if B.degree(v) != h1.shape[1]:
            raise ValueError("every base-graph vertex degree has to equal the local block length")

    group = list(group)
    gidx = {g: i for i, g in enumerate(group)}
    G = len(group)
    nE = B.num_edges
    nV = B.num_vertices
    r1 = h1.shape[0]
    r2 = h2.shape[0]

    # flat index helpers (mixed radix)
    def xc_index(e1, g, v2, rr2):
        return ((e1 * G + g) * nV + v2) * r2 + rr2

    n_xchecks = nE * G * nV * r2

    ee_base = 0
    n_ee = nE * G * nE

    def ee_index(e1, g, e2):
        return ee_base + (e1 * G + g) * nE + e2

    vv_base = n_ee
    n_vv = nV * r1 * G * nV * r2

    def vv_index(v1, rr1, g, v2, rr2):
        return vv_base + (((v1 * r1 + rr1) * G + g) * nV + v2) * r2 + rr2

    n_qubits = n_ee + n_vv

    def zc_index(v1, rr1, g, e2):
        return ((v1 * r1 + rr1) * G + g) * nE + e2

    n_zchecks = nV * r1 * G * nE

    # precompute group-index translations used by the supports
    left_mul = np.empty((nE, G), dtype=np.int64)  # g -> edge_gen @ g
    right_mul_inv = np.empty((G, nE), dtype=np.int64)  # g -> g @ edge_gen^-1
    for e in range(nE):
        ge = B.edges[e][2]
        ge_inv = ge.inv()
        for gi, g in enumerate(group):
            left_mul[e, gi] = gidx[ge @ g]
            right_mul_inv[gi, e] = gidx[g @ ge_inv]

    # local-system supports, precomputed once:
    #   h1 row supports at each (vertex, edge) slot; h2 edge supports per row
    h1_head = {}  # (v, e) incoming -> rows of h1 supported there
    h1_tail = {}
    for v in range(nV):
        for e in B.in_edges[v]:
            h1_head[(v, e)] = np.nonzero(h1[:, B.in_col[v][e]])[0]
        for e in B.out_edges[v]:
            h1_tail[(v, e)] = np.nonzero(h1[:, B.out_col[v][e]])[0]
    # out_e2s[v][rr2] / in_e2s[v][rr2]: edges at v whose h2 column supports row rr2
    out_e2s = [[[e for e in B.out_edges[v] if h2[rr, B.out_col[v][e]]] for rr in range(r2)]
               for v in range(nV)]
    in_e2s = [[[e for e in B.in_edges[v] if h2[rr, B.in_col[v][e]]] for rr in range(r2)]
              for v in range(nV)]

    # ---- partial_2: qubit x X-check ----
    p2_rows: List[int] = []
    p2_cols: List[int] = []
    for e1 in range(nE):
        u1, v1, _ = B.edges[e1]
        rows_head = h1_head[(v1, e1)]
        rows_tail = h1_tail[(u1, e1)]
        for gi in range(G):
            g_head = left_mul[e1, gi]
            for v2 in range(nV):
                for rr2 in range(r2):
                    xc = xc_index(e1, gi, v2, rr2)
                    # ExV -> VxV
                    for rr1 in rows_head:
                        p2_rows.append(vv_index(v1, rr1, g_head, v2, rr2))
                        p2_cols.append(xc)
                    for rr1 in rows_tail:
                        p2_rows.append(vv_index(u1, rr1, gi, v2, rr2))
                        p2_cols.append(xc)
                    # ExV -> ExE
                    for e2 in out_e2s[v2][rr2]:
                        p2_rows.append(ee_index(e1, gi, e2))
                        p2_cols.append(xc)
                    for e2 in in_e2s[v2][rr2]:
                        p2_rows.append(ee_index(e1, right_mul_inv[gi, e2], e2))
                        p2_cols.append(xc)

    # ---- partial_1: Z-check x qubit ----
    p1_rows: List[int] = []
    p1_cols: List[int] = []
    # ExE qubits
    for e1 in range(nE):
        u1, v1, _ = B.edges[e1]
        rows_head = h1_head[(v1, e1)]
        rows_tail = h1_tail[(u1, e1)]
        for gi in range(G):
            g_head = left_mul[e1, gi]
            for e2 in range(nE):
                q = ee_index(e1, gi, e2)
                for rr1 in rows_head:
                    p1_rows.append(zc_index(v1, rr1, g_head, e2))
                    p1_cols.append(q)
                for rr1 in rows_tail:
                    p1_rows.append(zc_index(u1, rr1, gi, e2))
                    p1_cols.append(q)
    # VxV qubits
    for v1 in range(nV):
        for rr1 in range(r1):
            for gi in range(G):
                for v2 in range(nV):
                    for rr2 in range(r2):
                        q = vv_index(v1, rr1, gi, v2, rr2)
                        for e2 in out_e2s[v2][rr2]:
                            p1_rows.append(zc_index(v1, rr1, gi, e2))
                            p1_cols.append(q)
                        for e2 in in_e2s[v2][rr2]:
                            p1_rows.append(zc_index(v1, rr1, right_mul_inv[gi, e2], e2))
                            p1_cols.append(q)

    partial_2 = sparse.coo_matrix(
        (np.ones(len(p2_rows), dtype=np.int64), (p2_rows, p2_cols)),
        shape=(n_qubits, n_xchecks),
    ).tocsr()
    partial_1 = sparse.coo_matrix(
        (np.ones(len(p1_rows), dtype=np.int64), (p1_rows, p1_cols)),
        shape=(n_zchecks, n_qubits),
    ).tocsr()
    partial_2.data = partial_2.data % 2
    partial_1.data = partial_1.data % 2
    partial_2.eliminate_zeros()
    partial_1.eliminate_zeros()

    if check_complex:
        assert np.all((partial_1 @ partial_2).data % 2 == 0)

    checks = QuantumCodeChecks(
        partial_2.T.astype(np.uint32), partial_1.astype(np.uint32)
    )
    logicals = get_logicals(checks, compute_logicals=compute_logicals, check_complex=check_complex)
    assert checks.x.shape[1] == checks.z.shape[1]
    assert len(logicals.x) == len(logicals.z)
    qc_meta = _abelian_qc_layout(group, nE, nV, r1, r2)
    return QuantumCode(checks, logicals, qc_meta=qc_meta)


def _abelian_qc_layout(group, nE: int, nV: int, r1: int, r2: int):
    """Block-circulant layout of a lifted product over an abelian group.

    Over ``Zqm`` the group action on the flat lex index of the coordinate
    tuple is a multi-dimensional cyclic shift, so moving the group axis
    innermost (and relabelling DFS order -> lex order) turns every check
    matrix into a grid of circulant blocks over dims = (q,)*m.  Returns the
    :class:`~exp_ldpc_tpu.codes.qc_meta.BlockCirculantMeta` with new->old
    permutations per the mixed-radix layouts of :func:`lifted_product_code`,
    or ``None`` for non-abelian groups.
    """
    if not all(isinstance(g, Zqm) for g in group):
        return None
    from .qc_meta import BlockCirculantMeta

    q, m = group[0].q, group[0].m
    dims = (q,) * m
    G = len(group)
    if G != q ** m:  # generators span a subgroup only: lex relabel undefined
        return None
    # DFS position of the group element with flat lex index ell
    gi_of_lex = np.empty(G, dtype=np.int64)
    for gi, g in enumerate(group):
        gi_of_lex[int(np.ravel_multi_index(g.data, dims))] = gi

    def move_g_inner(outer: int, inner: int) -> np.ndarray:
        """(outer, G, inner) mixed-radix -> new order (outer, inner, lex-G)."""
        a = np.arange(outer)[:, None, None]
        b = np.arange(inner)[None, :, None]
        gl = gi_of_lex[None, None, :]
        return ((a * G + gl) * inner + b).reshape(-1)

    # index layouts (see lifted_product_code): X checks (e1, g, v2, r2);
    # qubits EE (e1, g, e2) then VV (v1, r1, g, v2, r2); Z checks (v1, r1, g, e2)
    x_perm = move_g_inner(nE, nV * r2)
    z_perm = move_g_inner(nV * r1, nE)
    qubit_perm = np.concatenate(
        [move_g_inner(nE, nE), nE * G * nE + move_g_inner(nV * r1, nV * r2)]
    )
    return BlockCirculantMeta(
        dims=dims, qubit_perm=qubit_perm, x_check_perm=x_perm, z_check_perm=z_perm
    )


def _lifted_product_code_wrapper(
    generators, r, compute_logicals, seed, check_complex, r2=None, double_cover=None
) -> QuantumCode:
    """Random-local-system wrapper shared by the LP constructors
    (reference ``:411-428``)."""
    assert r > 0
    r1 = r
    if r2 is None:
        r2 = r1
    if compute_logicals is None:
        compute_logicals = True
    if check_complex is None:
        check_complex = False
    w = len(generators)
    group = dfs_generators(generators[0].identity(), generators)
    h1 = random_check_matrix(r1, w if double_cover else w * 2, seed=seed + 1 if seed is not None else None)
    h2 = random_check_matrix(r2, w if double_cover else w * 2, seed=seed + 2 if seed is not None else None)
    return lifted_product_code(
        group,
        generators,
        h1,
        h2,
        check_complex=check_complex,
        compute_logicals=compute_logicals,
        double_cover=double_cover,
    )


def lifted_product_code_cyclic(
    q, m, w, r, compute_logicals=None, r2=None, seed=None, check_complex=None, double_cover=None
) -> QuantumCode:
    """LP over Z_q^m with w random generators (reference ``:430-445``)."""
    assert q > 0 and m > 0 and w > 0
    if double_cover is None:
        double_cover = False
    generators = random_abelian_generators(q, m, w, seed=seed)
    return _lifted_product_code_wrapper(
        generators, r, compute_logicals=compute_logicals, r2=r2, seed=seed,
        check_complex=check_complex, double_cover=double_cover,
    )


def lifted_product_code_pgl2(l, i, r, *args, **kwargs):
    """LP over PGL(2, (2^l)^i) with Morgenstern generators (reference ``:447-453``)."""
    generators = morgenstern_generators(l, i)
    return _lifted_product_code_wrapper(generators, r, *args, **kwargs)
