"""Parity products of 0/1 arrays on the host, shared by the decode drivers
and the sliding-window decoder.

Each product is taken in float64: exact (every sum is a small integer) and
a BLAS call, where numpy's integer product is a plain loop (seconds for
16,384 shots).
"""
from __future__ import annotations

import numpy as np

__all__ = ["mod2_matmul", "spacetime_syndromes"]


def mod2_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(a @ b) mod 2 of 0/1 arrays, int64."""
    return (np.asarray(a, dtype=np.float64) @ np.asarray(b, dtype=np.float64) % 2).astype(np.int64)


def spacetime_syndromes(spacetime, history: np.ndarray, readout: np.ndarray) -> np.ndarray:
    """``spacetime.syndrome_from_history_batch`` with the readout's parity
    product taken in float64 (the same values)."""
    return spacetime.syndrome_from_history_batch(history, np.asarray(readout, dtype=np.float64))
