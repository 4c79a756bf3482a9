"""Bipartite Tanner-graph combinatorics, dependency-free.

Re-designed equivalents of the reference's networkx-based layer
(``reference/python/qldpc/random_biregular_graph.py`` and
``edge_coloring.py``) built on flat edge arrays + adjacency sets instead of a
general graph library: the three operations we need (configuration-model
generation, girth repair by edge swaps, Kőnig edge coloring) are all simple
enough that a purpose-built representation is both faster and clearer, and it
removes the O(n) edge-sampling workaround the reference had to carry
(``random_biregular_graph.py:130-136``).

Algorithms (both published, implemented from the papers' descriptions):
  * shortest-cycle detection — I. Alon and M. Rodeh, SIAM J. Comput. 7(4) (1978)
    (used by the reference at ``random_biregular_graph.py:91-118``)
  * optimal bipartite edge coloring — constructive Kőnig/Kempe-chain argument
    (used by the reference at ``edge_coloring.py:17-87``), O(V·E).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
from scipy import sparse

__all__ = [
    "BipartiteGraph",
    "random_biregular_graph",
    "remove_short_cycles",
    "search_cycle",
    "edge_color_bipartite",
]


@dataclass
class BipartiteGraph:
    """Simple bipartite graph: left vertices 0..n_left-1, right vertices 0..n_right-1.

    In Tanner-graph usage the left side is the data/variable nodes and the
    right side the check nodes (matching the reference's ``bipartite=0`` data
    convention at ``random_biregular_graph.py:22-27``).
    """

    n_left: int
    n_right: int
    left_adj: List[set] = field(default_factory=list)
    right_adj: List[set] = field(default_factory=list)

    @classmethod
    def from_edges(cls, n_left: int, n_right: int, edges) -> "BipartiteGraph":
        g = cls(n_left, n_right, [set() for _ in range(n_left)], [set() for _ in range(n_right)])
        for u, v in edges:
            g.add_edge(int(u), int(v))
        return g

    def add_edge(self, u: int, v: int) -> None:
        if v in self.left_adj[u]:
            raise ValueError(f"duplicate edge ({u},{v}) in simple bipartite graph")
        self.left_adj[u].add(v)
        self.right_adj[v].add(u)

    def remove_edge(self, u: int, v: int) -> None:
        self.left_adj[u].remove(v)
        self.right_adj[v].remove(u)

    def has_edge(self, u: int, v: int) -> bool:
        return v in self.left_adj[u]

    def edges(self) -> List[Tuple[int, int]]:
        return [(u, v) for u in range(self.n_left) for v in sorted(self.left_adj[u])]

    @property
    def num_edges(self) -> int:
        return sum(len(s) for s in self.left_adj)

    def left_degrees(self) -> np.ndarray:
        return np.array([len(s) for s in self.left_adj])

    def right_degrees(self) -> np.ndarray:
        return np.array([len(s) for s in self.right_adj])

    def biadjacency(self) -> sparse.csr_matrix:
        """(n_left, n_right) 0/1 CSR matrix; rows are left (data) vertices."""
        rows, cols = [], []
        for u in range(self.n_left):
            for v in sorted(self.left_adj[u]):
                rows.append(u)
                cols.append(v)
        return sparse.csr_matrix(
            (np.ones(len(rows), dtype=np.int64), (rows, cols)),
            shape=(self.n_left, self.n_right),
        )


def random_biregular_graph(
    num_checks: int,
    num_data: int,
    data_degree: int,
    check_degree: int,
    seed=None,
    graph_multiedge_retries: Optional[int] = None,
) -> BipartiteGraph:
    """Uniform-ish (data_degree, check_degree)-biregular bipartite graph.

    Configuration model: pair data stubs with a random permutation of check
    stubs, then repair the few resulting parallel edges by random endpoint
    swaps (each swap preserves both degree sequences).  Behavioral parity
    with ``random_biregular_graph.py:14-89``; the swap-repair loop is our own
    array formulation.
    """
    if graph_multiedge_retries is None:
        graph_multiedge_retries = 100
    if num_checks * check_degree != num_data * data_degree:
        raise RuntimeError("biregularity needs num_data*data_degree == num_checks*check_degree")

    rng = np.random.default_rng(seed)
    left = np.repeat(np.arange(num_data), data_degree)
    right = np.repeat(np.arange(num_checks), check_degree)
    rng.shuffle(right)

    num_edges = left.shape[0]
    for _ in range(graph_multiedge_retries):
        # locate parallel edges: all occurrences beyond the first of each (l, r) pair
        key = left.astype(np.int64) * num_checks + right
        order = np.argsort(key, kind="stable")
        sorted_key = key[order]
        dup_mask = np.zeros(num_edges, dtype=bool)
        dup_positions = order[1:][sorted_key[1:] == sorted_key[:-1]]
        dup_mask[dup_positions] = True
        if not dup_positions.size:
            break
        # swap the right endpoint of every duplicate with a random other edge
        partners = rng.choice(num_edges, size=dup_positions.size, replace=False)
        for i, j in zip(dup_positions, partners):
            right[i], right[j] = right[j], right[i]
    else:
        raise RuntimeError("multiedge repair did not converge; raise graph_multiedge_retries")

    return BipartiteGraph.from_edges(num_data, num_checks, zip(left, right))


def search_cycle(
    graph: BipartiteGraph, source: int, depth_limit: int, from_left: bool = True
) -> Optional[Tuple[int, Tuple[int, int]]]:
    """BFS cycle detection from `source` (Alon–Rodeh).

    Returns ``(length, (u, v))`` where the edge (u, v) lies on a shortest
    cycle through `source` (exact for bipartite graphs), or None if no cycle
    of length <= 2*depth_limit passes through `source`.  Vertices are
    addressed as (side, index); `from_left` selects the source's side.
    Parity with ``random_biregular_graph.py:91-118``.
    """
    # encode vertices as signed ids: left u -> u, right v -> n_left + v
    n_left = graph.n_left

    def neighbors(x):
        if x < n_left:
            return (n_left + v for v in graph.left_adj[x])
        return iter(graph.right_adj[x - n_left])

    src = source if from_left else n_left + source
    level = {src: 0}
    queue = [src]
    qi = 0
    while qi < len(queue):
        u = queue[qi]
        qi += 1
        u_level = level[u]
        for nb in neighbors(u):
            n_level = level.get(nb)
            if n_level is None:
                level[nb] = u_level + 1
                if u_level + 1 < depth_limit:
                    queue.append(nb)
            elif u_level <= n_level:
                # cross/level edge closes a cycle of length 2*(u_level+1)
                a, b = (u, nb) if u < n_left else (nb, u)
                return (2 * (u_level + 1), (a, b - n_left))
    return None


def remove_short_cycles(
    graph: BipartiteGraph, girth_bound: int, seed=None, patience: int = 1_000_000
) -> None:
    """Raise the girth strictly above `girth_bound` by random edge swaps (in place).

    Parity with ``random_biregular_graph.py:121-178``: repeatedly pick a
    random left vertex, find an edge on a short cycle through it, and swap
    that edge with a uniformly random other edge when the swap keeps the
    graph simple.  Direct uniform edge sampling replaces the reference's
    degree-weighted-vertex workaround.
    """
    depth_limit = girth_bound // 2
    rng = np.random.default_rng(seed)
    exit_check_interval = max(graph.n_left * 10, 1)

    def full_clear() -> bool:
        return all(
            search_cycle(graph, v, depth_limit) is None for v in range(graph.n_left)
        )

    edge_list = graph.edges()
    edge_index = {e: i for i, e in enumerate(edge_list)}

    def swap_in(old: Tuple[int, int], new: Tuple[int, int]) -> None:
        i = edge_index.pop(old)
        edge_list[i] = new
        edge_index[new] = i

    for t in range(patience):
        if t % exit_check_interval == 0 and full_clear():
            break
        node = int(rng.integers(graph.n_left))
        found = search_cycle(graph, node, depth_limit)
        if found is None:
            continue
        _, (u1, v1) = found
        for _ in range(patience):
            u2, v2 = edge_list[int(rng.integers(len(edge_list)))]
            if u1 == u2 or v1 == v2:
                continue
            if graph.has_edge(u2, v1) or graph.has_edge(u1, v2):
                continue
            graph.remove_edge(u1, v1)
            graph.remove_edge(u2, v2)
            graph.add_edge(u1, v2)
            graph.add_edge(u2, v1)
            swap_in((u1, v1), (u1, v2))
            swap_in((u2, v2), (u2, v1))
            break
        else:
            raise RuntimeError(
                "Patience exceeded while selecting an edge to swap in short cycle removal."
            )
    else:
        if not full_clear():
            raise RuntimeError("Patience exceeded while removing short cycles.")


def edge_color_bipartite(
    n_left: int, n_right: int, edges: List[Tuple[int, int]]
) -> np.ndarray:
    """Optimal Δ-edge-coloring of a bipartite multigraph.

    `edges` is a list of (left, right) pairs; parallel edges are allowed and
    colored independently.  Returns an int array `color[edge_id]` with values
    in [0, Δ).  Kőnig's constructive proof via Kempe-chain recoloring, O(V·E)
    worst case; fills the role of ``edge_coloring.py:17-87``.
    """
    edges = list(edges)
    degrees = np.zeros(n_left + n_right, dtype=np.int64)
    for u, v in edges:
        degrees[u] += 1
        degrees[n_left + v] += 1
    delta = int(degrees.max(initial=0))

    # vertex x color -> edge id (-1 = free)
    slot = np.full((n_left + n_right, max(delta, 1)), -1, dtype=np.int64)
    color = np.full(len(edges), -1, dtype=np.int64)

    def first_free(vertex: int) -> int:
        row = slot[vertex]
        free = np.nonzero(row == -1)[0]
        return int(free[0])

    for eid, (u, v_) in enumerate(edges):
        v = n_left + v_
        alpha = first_free(u)
        beta = first_free(v)
        if alpha != beta and slot[v, alpha] != -1:
            # walk the maximal alternating (alpha, beta) path from v and swap
            # colors along it; bipartiteness guarantees it never reaches u.
            path = []
            vertex, want = v, alpha
            while slot[vertex, want] != -1:
                e2 = int(slot[vertex, want])
                path.append(e2)
                a, b_ = edges[e2]
                b = n_left + b_
                vertex = b if vertex == a else a
                want = beta if want == alpha else alpha
            for e2 in path:
                a, b_ = edges[e2]
                b = n_left + b_
                old = int(color[e2])
                new = beta if old == alpha else alpha
                color[e2] = new
                for x in (a, b):
                    slot[x, old] = -1 if slot[x, old] == e2 else slot[x, old]
                    slot[x, new] = e2
            assert slot[v, alpha] == -1
        color[eid] = alpha
        slot[u, alpha] = eid
        slot[v, alpha] = eid
    return color
