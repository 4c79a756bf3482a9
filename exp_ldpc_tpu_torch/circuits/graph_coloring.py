"""Check-matrix -> depth-optimal measurement schedule via edge coloring.

Bridges the sparse check matrices to the flat-edge-array coloring kernel in
:mod:`exp_ldpc_tpu.codes.graphs`.  Fills the role of the networkx round trip
at ``reference/python/qldpc/storage_sim.py:14-30``.
"""
from __future__ import annotations

from typing import Dict, List

from scipy import sparse

from ..codes.graphs import edge_color_bipartite

__all__ = ["color_csr_checks"]


def color_csr_checks(checks: sparse.csr_matrix) -> List[Dict[int, int]]:
    """Color the Tanner graph of a check matrix.

    Returns one ``{check_index: data_index}`` dict per color/timestep; every
    (check, data) edge appears in exactly one timestep and no check or data
    qubit is used twice in a timestep.
    """
    checks = checks.tocsr()
    coo = checks.tocoo()
    edges = list(zip(coo.row.tolist(), coo.col.tolist()))
    colors = edge_color_bipartite(checks.shape[0], checks.shape[1], edges)
    num_colors = int(colors.max(initial=-1)) + 1
    schedule: List[Dict[int, int]] = [dict() for _ in range(num_colors)]
    for (check, data), c in zip(edges, colors):
        schedule[c][check] = data
    return schedule
