"""Hardware permutation routing by swap networks.

Behavioral parity with ``reference/python/qldpc/swap_route.py``:

  * :func:`product_permutation_route` — congestion-free routing on a product
    graph G x H via edge coloring of the column multigraph
    (M. Baumslag and F. Annexstein, Math. Systems Theory 24, 233-251 (1991));
  * :func:`grid_permutation_route` — grid realization through three stages of
    even/odd-transposition sorting networks, returning parallel swap layers.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, List, Tuple

import numpy as np

from .graphs import edge_color_bipartite

__all__ = ["product_permutation_route", "grid_permutation_route"]

Swap = Tuple[Tuple[int, int], Tuple[int, int]]


def product_permutation_route(R: np.ndarray) -> np.ndarray:
    """Routing rows for a permutation on G x H.

    R[g0, h0] = (g1, h1) is the destination of (g0, h0).  Returns A with
    A[g0, h0] = g meaning: route (g0,h0) -> (g,h0) -> (g,h1) -> (g1,h1).
    The intermediate rows come from an optimal edge coloring of the bipartite
    column multigraph (one edge (h0 -> h1) per element), which decomposes it
    into perfect matchings — one routing row per color.
    """
    G_size, H_size = R.shape[0], R.shape[1]
    assert R.shape == (G_size, H_size, 2)
    assert np.all((0 <= R[:, :, 0]) & (R[:, :, 0] < G_size))
    assert np.all((0 <= R[:, :, 1]) & (R[:, :, 1] < H_size))
    flat = {(int(R[i, j, 0]), int(R[i, j, 1])) for i in range(G_size) for j in range(H_size)}
    assert len(flat) == G_size * H_size, "destinations must form a permutation"

    # column multigraph: edge h0 -> destination column for every element
    edges = []
    edge_owner = []  # g0 of each edge
    for g0 in range(G_size):
        for h0 in range(H_size):
            edges.append((h0, int(R[g0, h0, 1])))
            edge_owner.append(g0)
    colors = edge_color_bipartite(H_size, H_size, edges)

    A = np.zeros((G_size, H_size), dtype=np.int64)
    for eid, c in enumerate(colors):
        h0 = edges[eid][0]
        A[edge_owner[eid], h0] = c
    return A


def _oet_schedule(K: np.ndarray) -> Tuple[np.ndarray, List[Tuple[int, np.ndarray]]]:
    """Batched odd-even transposition sort over the rows of a key matrix.

    Every row of ``K`` (shape ``(nseq, L)``) is sorted simultaneously with the
    canonical L-timestep odd-even transposition network.  Instead of mutating
    payload arrays through compare/swap callbacks, the whole network is driven
    by vectorized comparisons on the key matrix:

      * ``masks`` — one ``(offset, swapped)`` pair per timestep, where
        ``swapped[s, k]`` says whether sequence ``s`` exchanged positions
        ``offset + 2k`` and ``offset + 2k + 1`` at that timestep;
      * ``order`` — the accumulated permutation, ``order[s, p]`` = original
        position of the element that ends up at position ``p`` of sequence
        ``s`` (apply with ``np.take_along_axis``).
    """
    K = np.ascontiguousarray(K).copy()
    nseq, L = K.shape
    order = np.broadcast_to(np.arange(L), (nseq, L)).copy()
    masks: List[Tuple[int, np.ndarray]] = []
    for t in range(L):
        off = t & 1
        left = np.arange(off, L - 1, 2)
        if left.size == 0:
            masks.append((off, np.zeros((nseq, 0), dtype=bool)))
            continue
        right = left + 1
        ka, kb = K[:, left], K[:, right]
        swapped = ka > kb
        K[:, left] = np.where(swapped, kb, ka)
        K[:, right] = np.where(swapped, ka, kb)
        oa, ob = order[:, left], order[:, right]
        order[:, left] = np.where(swapped, ob, oa)
        order[:, right] = np.where(swapped, oa, ob)
        masks.append((off, swapped))
    return order, masks


def _masks_to_timesteps(
    masks: List[Tuple[int, np.ndarray]], along_columns: bool
) -> List[Deque[Swap]]:
    """Convert per-timestep swap masks into grid-coordinate swap deques.

    For a column stage, sequence ``s`` is grid column ``s`` and the sorted
    position is the grid row; for a row stage the roles are exchanged.
    """
    timesteps: List[Deque[Swap]] = []
    for off, swapped in masks:
        timestep: Deque[Swap] = deque()
        seqs, slots = np.nonzero(swapped)
        for s, k in zip(seqs.tolist(), slots.tolist()):
            p = off + 2 * k
            if along_columns:
                timestep.append(((p, s), (p + 1, s)))
            else:
                timestep.append(((s, p), (s, p + 1)))
        timesteps.append(timestep)
    return timesteps


def grid_permutation_route(R: np.ndarray) -> List[Deque[Swap]]:
    """Nearest-neighbour swap schedule realizing a grid permutation.

    Behavioral counterpart of reference ``swap_route.py:100-135`` (three
    sorting-network stages: each column by routing row, each row by
    destination column, each column by destination row), but computed as a
    batch: each stage extracts one key matrix, runs the whole
    odd-even-transposition network for *all* sequences at once via
    :func:`_oet_schedule`, translates the boolean swap masks into disjoint
    per-timestep grid swaps, and applies the stage's accumulated ``order``
    permutation to the route tensor with ``np.take_along_axis``.
    """
    G_size, H_size = R.shape[0], R.shape[1]
    routing_row = np.reshape(product_permutation_route(R), (G_size, H_size, 1))
    route = np.concatenate([R, routing_row], axis=2)
    swaps: List[Deque[Swap]] = []

    # (along_columns, key-plane) per stage: routing row, dest column, dest row.
    for along_columns, key in ((True, 2), (False, 1), (True, 0)):
        if along_columns:
            keys = route[:, :, key].T  # one sequence per grid column
        else:
            keys = route[:, :, key]  # one sequence per grid row
        order, masks = _oet_schedule(keys)
        swaps.extend(_masks_to_timesteps(masks, along_columns))
        if along_columns:
            route = np.take_along_axis(route, order.T[:, :, None], axis=0)
        else:
            route = np.take_along_axis(route, order[:, :, None], axis=1)

    assert np.array_equal(
        route[:, :, 0], np.broadcast_to(np.arange(G_size)[:, None], (G_size, H_size))
    ) and np.array_equal(
        route[:, :, 1], np.broadcast_to(np.arange(H_size), (G_size, H_size))
    ), "swap schedule failed to realize the permutation"
    return swaps
