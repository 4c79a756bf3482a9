"""The work of a batch's device decode, counted from its BP stages' shapes:
each stage's bound reads its inputs and outputs once and 11 operations per
edge, shot and iteration.  A decode mode (``benchmark/modes/``) sums its
stages."""
from __future__ import annotations

import numpy as np

from .bounds import OPS_FLOAT, bound, flat_io, st_io
from .reference.codes import spacetime_matrix


class Tab:
    """The sizes of a matrix's Tanner tables, as ``bounds.table_bytes`` reads them."""

    def __init__(self, H: np.ndarray):
        self.num_checks, self.num_vars = H.shape
        self.max_check_degree = int(H.sum(axis=1).max())
        self.max_var_degree = int(H.sum(axis=0).max())


def st_bound_ms(h: np.ndarray, rounds: int, shots: int, iters: int) -> float:
    """The least time of a spacetime stage on ``h`` over ``rounds`` rounds."""
    h = np.asarray(h, dtype=np.int64) % 2
    st = spacetime_matrix(h, rounds)
    return bound(st_io(st.shape[0], st.shape[1], Tab(h), shots),
                 OPS_FLOAT * int(st.sum()) * shots * iters)["bound_ms"]


def flat_bound_ms(H: np.ndarray, shots: int, iters: int) -> float:
    """The least time of a flat stage on ``H`` (H itself, or (H|I))."""
    H = np.asarray(H, dtype=np.int64) % 2
    return bound(flat_io(Tab(H), shots), OPS_FLOAT * int(H.sum()) * shots * iters)["bound_ms"]


def with_identity(h: np.ndarray) -> np.ndarray:
    """(H|I): a measurement-error column for each check."""
    h = np.asarray(h, dtype=np.int64) % 2
    return np.hstack([h, np.eye(h.shape[0], dtype=np.int64)])
