"""Hypergraph product codes from random biregular Tanner graphs.

Parity with ``reference/python/qldpc/hypergraph_product_code.py``:
a (data_degree, check_degree)-biregular classical Tanner graph defines a
boundary map; the quantum code is the homological product of that complex
with its dual, giving n = num_data^2 + num_checks^2 qubits.
"""
from __future__ import annotations

from typing import Optional

from ..core import QuantumCode
from .graphs import random_biregular_graph, remove_short_cycles
from .homological import homological_product

__all__ = ["biregular_hgp", "random_test_hgp"]


def biregular_hgp(
    num_data: int,
    data_degree: int,
    check_degree: int,
    check_complex=None,
    seed=None,
    graph_multiedge_retries=None,
    compute_logicals=None,
    girth_bound=None,
    girth_bound_patience=None,
) -> QuantumCode:
    """HGP of a random (data_degree, check_degree)-biregular graph with its dual.

    Matches ``hypergraph_product_code.py:7-35`` including the derived check
    count ``num_checks = num_data * data_degree / check_degree`` and the
    optional girth repair of the classical graph.
    """
    num_checks = (num_data * data_degree) // check_degree
    graph = random_biregular_graph(
        num_checks,
        num_data,
        data_degree,
        check_degree,
        seed=seed,
        graph_multiedge_retries=graph_multiedge_retries,
    )
    if girth_bound is not None:
        if girth_bound_patience is None:
            girth_bound_patience = 10000
        remove_short_cycles(
            graph,
            girth_bound,
            seed=seed + 1 if seed is not None else None,
            patience=girth_bound_patience,
        )

    boundary_map = graph.biadjacency().astype(int)  # (num_data, num_checks)
    coboundary_map = boundary_map.transpose()

    code = homological_product(
        boundary_map,
        coboundary_map,
        check_complex=check_complex,
        compute_logicals=compute_logicals,
    )
    assert len(code.logicals.x) == len(code.logicals.z)
    assert code.checks.x.shape == code.checks.z.shape
    assert code.checks.num_qubits == num_data**2 + num_checks**2
    return code


def random_test_hgp(compute_logicals: Optional[bool] = None) -> QuantumCode:
    """The standard 2025-qubit test fixture (``hypergraph_product_code.py:37-40``)."""
    if compute_logicals is None:
        compute_logicals = True
    return biregular_hgp(36, 3, 4, seed=42, compute_logicals=compute_logicals, girth_bound=4)
