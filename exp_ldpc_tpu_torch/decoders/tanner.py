"""Padded-ELL Tanner-graph device representation.

The core data structure the batched BP kernels consume (SURVEY.md §7 layer 3).
A sparse check matrix H (r x n) is compiled to two dual static-index layouts:

  * check-major: for each check, its incident edge ids / variable ids, padded
    to the max check degree Dc;
  * variable-major: for each variable, its incident edge ids / check ids,
    padded to the max variable degree Dv.

Messages live in edge-major arrays with ONE extra padding slot at index E;
padded index entries point at that slot, so gathers read a neutral element
(+inf for min-trees, 0 for sums) and scatters harmlessly overwrite it.  All
shapes are static — no data-dependent control flow reaches XLA.

For the scatter-free BP formulation (XLA scatters serialize on TPU; gathers
ride the fast row-copy path) the two layouts are additionally linked by flat
PERMUTATION maps: ``vm_from_cm[v, j]`` is the flattened check-major slot
``c*Dc + i`` holding the same edge as variable-major slot ``(v, j)`` (or the
one-past-end pad index ``C*Dc`` for padded slots), and symmetrically
``cm_from_vm``.  One BP iteration is then elementwise math in one layout plus
a single static gather into the other — no scatters anywhere.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy import sparse

__all__ = ["TannerELL"]


@dataclass(frozen=True, eq=False)  # identity hash: instances are jit static args
class TannerELL:
    num_checks: int
    num_vars: int
    num_edges: int
    # check-major (C, Dc)
    chk_edges: np.ndarray  # edge id, padded with num_edges
    chk_vars: np.ndarray  # variable id, padded with 0
    chk_mask: np.ndarray  # bool
    # variable-major (V, Dv)
    var_edges: np.ndarray
    var_checks: np.ndarray
    var_mask: np.ndarray
    # flat cross-layout permutations (pad index = one past end of the source)
    vm_from_cm: np.ndarray  # (V, Dv) -> index into flattened (C*Dc [+pad]) array
    cm_from_vm: np.ndarray  # (C, Dc) -> index into flattened (V*Dv [+pad]) array

    @classmethod
    def from_check_matrix(cls, H) -> "TannerELL":
        H = sparse.csr_matrix(H)
        H = H.copy()
        H.data = H.data % 2
        H.eliminate_zeros()
        H.sort_indices()
        r, n = H.shape
        coo = H.tocoo()
        # edge order: by (check, variable) — CSR order
        checks = coo.row.astype(np.int32)
        variables = coo.col.astype(np.int32)
        E = checks.shape[0]

        chk_deg = np.bincount(checks, minlength=r)
        var_deg = np.bincount(variables, minlength=n)
        Dc = int(chk_deg.max(initial=1))
        Dv = int(var_deg.max(initial=1))

        chk_edges = np.full((r, Dc), E, dtype=np.int32)
        chk_vars = np.zeros((r, Dc), dtype=np.int32)
        chk_mask = np.zeros((r, Dc), dtype=bool)
        slot = np.zeros(r, dtype=np.int64)
        for e in range(E):
            c = checks[e]
            s = slot[c]
            chk_edges[c, s] = e
            chk_vars[c, s] = variables[e]
            chk_mask[c, s] = True
            slot[c] += 1

        var_edges = np.full((n, Dv), E, dtype=np.int32)
        var_checks = np.zeros((n, Dv), dtype=np.int32)
        var_mask = np.zeros((n, Dv), dtype=bool)
        slot = np.zeros(n, dtype=np.int64)
        var_slot_of_edge = np.zeros(E, dtype=np.int64)
        for e in range(E):
            v = variables[e]
            s = slot[v]
            var_edges[v, s] = e
            var_checks[v, s] = checks[e]
            var_mask[v, s] = True
            var_slot_of_edge[e] = s
            slot[v] += 1

        # cross-layout permutations: edge e lives at check-major slot
        # (check[e], chk_slot) and variable-major slot (var[e], var_slot)
        chk_slot_of_edge = np.zeros(E, dtype=np.int64)
        fill = np.zeros(r, dtype=np.int64)
        for e in range(E):
            c = checks[e]
            chk_slot_of_edge[e] = fill[c]
            fill[c] += 1

        vm_from_cm = np.full((n, Dv), r * Dc, dtype=np.int32)
        cm_from_vm = np.full((r, Dc), n * Dv, dtype=np.int32)
        cm_flat = checks.astype(np.int64) * Dc + chk_slot_of_edge
        vm_flat = variables.astype(np.int64) * Dv + var_slot_of_edge
        vm_from_cm.reshape(-1)[vm_flat] = cm_flat.astype(np.int32)
        cm_from_vm.reshape(-1)[cm_flat] = vm_flat.astype(np.int32)

        return cls(
            num_checks=r,
            num_vars=n,
            num_edges=E,
            chk_edges=chk_edges,
            chk_vars=chk_vars,
            chk_mask=chk_mask,
            var_edges=var_edges,
            var_checks=var_checks,
            var_mask=var_mask,
            vm_from_cm=vm_from_cm,
            cm_from_vm=cm_from_vm,
        )

    @property
    def max_check_degree(self) -> int:
        return self.chk_edges.shape[1]

    @property
    def max_var_degree(self) -> int:
        return self.var_edges.shape[1]
