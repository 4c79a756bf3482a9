"""Random classical check matrices over GF(2).

Parity with ``reference/python/qldpc/random_code.py``.
"""
from __future__ import annotations

import numpy as np

from ..utils import gf2

__all__ = ["random_check_matrix"]


def random_check_matrix(r, n, seed=None, full_rank=None) -> np.ndarray:
    """Uniform random r x n 0/1 matrix; optionally rejection-sample until
    full rank (10k retries)."""
    if full_rank is None:
        full_rank = False
    rng = np.random.default_rng(seed)
    for _ in range(10000):
        h = rng.integers(low=0, high=2, size=(r, n)).astype(np.uint8)
        if not full_rank or gf2.rank(h) == min(h.shape):
            return h
    raise RuntimeError("Failed to construct random matrix: Number of retries exceeded")
