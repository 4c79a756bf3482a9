"""Spacetime (multi-round) decoding matrices.

Behavioral parity with ``reference/python/qldpc/spacetime_code.py``:

  * :class:`SpacetimeCodeSingleShot` — (H|I) extension, measurement-error
    bits appended per check (``spacetime_code.py:10-37``);
  * :class:`SpacetimeCode` — block-diagonal stack of H over rounds+1 with
    measurement-error columns linking consecutive rounds, syndrome-history
    differencing, final correction = mod-2 sum of per-round blocks
    (``spacetime_code.py:39-119``);
  * :class:`DetectorSpacetimeCode` — fault-check matrix / fault->logical map
    / fault priors built from a detector error model.  The reference version
    (``spacetime_code.py:122-183``) has a confirmed indexing bug (SURVEY.md
    §2.5.1: it connects faults to enumeration indices, not detector ids);
    ours takes a :class:`~exp_ldpc_tpu.decoders.dem.DetectorErrorModel`
    produced by our own fault propagation and uses the true ids.

The rounds axis is the framework's "long dimension" (SURVEY.md §5): the
spacetime matrix is block-banded with coupling only between adjacent rounds
through measurement-error columns, which is what makes the round axis
shardable with a 1-D halo.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import scipy.sparse as sparse

__all__ = ["SpacetimeCode", "SpacetimeCodeSingleShot", "DetectorSpacetimeCode"]


@dataclass(frozen=True, eq=False)
class SpacetimeCodeSingleShot:
    """(H | I): one measurement-error bit hung off each check."""

    spacetime_check_matrix: sparse.spmatrix
    _datablock_size: int

    def __init__(self, check_matrix: sparse.spmatrix):
        extended = sparse.hstack(
            [check_matrix, sparse.identity(check_matrix.shape[0], dtype=check_matrix.dtype)]
        ).tocsr()
        object.__setattr__(self, "_datablock_size", check_matrix.shape[1])
        object.__setattr__(self, "spacetime_check_matrix", extended)

    def final_correction(self, x):
        return self.data_bits(x)

    def data_bits(self, x):
        return x[..., : self._datablock_size]

    def measurement_bits(self, x):
        return x[..., self._datablock_size:]


@dataclass(frozen=True, eq=False)
class SpacetimeCode:
    """Multi-round spacetime check matrix over rounds+1 copies of H."""

    spacetime_check_matrix: sparse.spmatrix
    _check_matrix: sparse.spmatrix
    _num_rounds: int
    _datablock_size: int

    def __init__(self, check_matrix: sparse.spmatrix, num_rounds: int):
        check_matrix = sparse.csr_matrix(check_matrix)
        r, n = check_matrix.shape
        blocks = [check_matrix] * (num_rounds + 1)
        stacked = sparse.block_diag(blocks) if num_rounds > 0 else check_matrix.tocoo()

        # measurement-error columns: column j = round i, check c (j = i*r + c)
        # connects rows (i*r + c) and ((i+1)*r + c) — adjacent-round coupling only
        cols = np.arange(num_rounds * r)
        rows_lo = cols
        rows_hi = cols + r
        meas_block = sparse.coo_matrix(
            (
                np.ones(2 * num_rounds * r, dtype=np.uint32),
                (np.concatenate([rows_lo, rows_hi]), np.concatenate([cols, cols])),
            ),
            shape=((num_rounds + 1) * r, num_rounds * r),
        )
        spacetime = sparse.hstack([stacked, meas_block]).tocsr()

        object.__setattr__(self, "_check_matrix", check_matrix)
        object.__setattr__(self, "spacetime_check_matrix", spacetime)
        object.__setattr__(self, "_num_rounds", num_rounds)
        object.__setattr__(self, "_datablock_size", (num_rounds + 1) * n)

    def syndrome_from_history(self, history: Callable[[int], np.ndarray], readout: np.ndarray) -> np.ndarray:
        """Measurement history + transversal readout -> differenced spacetime syndrome."""
        r = self._check_matrix.shape[0]
        rounds = self._num_rounds
        syndrome = np.zeros((rounds + 1, r), dtype=np.int64)
        for i in range(rounds):
            syndrome[i] = history(i)
        syndrome[rounds] = (self._check_matrix @ readout) % 2
        # consecutive-round differencing localizes measurement errors
        syndrome[1:] = (syndrome[1:] + syndrome[:-1]) % 2
        return syndrome.reshape(-1)

    def syndrome_from_history_batch(self, history: np.ndarray, readout: np.ndarray) -> np.ndarray:
        """Vectorized variant: history (S, rounds, r), readout (S, n) ->
        (S, (rounds+1)*r) differenced syndromes."""
        S = history.shape[0]
        r = self._check_matrix.shape[0]
        rounds = self._num_rounds
        syndrome = np.zeros((S, rounds + 1, r), dtype=np.int64)
        syndrome[:, :rounds] = history
        syndrome[:, rounds] = (readout @ self._check_matrix.T.toarray()) % 2
        syndrome[:, 1:] = (syndrome[:, 1:] + syndrome[:, :-1]) % 2
        return syndrome.reshape(S, -1)

    def final_correction(self, spacetime_correction: np.ndarray) -> np.ndarray:
        """Mod-2 sum of the per-round data blocks (works batched on axis -1)."""
        n = self._check_matrix.shape[1]
        blocks = self.data_bits(spacetime_correction)
        shape = blocks.shape[:-1] + (self._num_rounds + 1, n)
        return blocks.reshape(shape).sum(axis=-2) % 2

    def data_bits(self, x):
        return x[..., : self._datablock_size]

    def measurement_bits(self, x):
        return x[..., self._datablock_size:]


@dataclass(frozen=True, eq=False)
class DetectorSpacetimeCode:
    """Fault-basis decoding matrices from a detector error model.

    fault_check_matrix: (num_detectors, num_faults); fault_map:
    (num_observables, num_faults); fault_priors: (num_faults,).
    """

    fault_check_matrix: sparse.spmatrix
    fault_map: sparse.spmatrix
    fault_priors: np.ndarray

    def __init__(self, detector_model):
        # detector_model: exp_ldpc_tpu.decoders.dem.DetectorErrorModel
        fcm = sparse.csr_matrix(detector_model.fault_detectors)
        fmap = sparse.csr_matrix(detector_model.fault_observables)
        object.__setattr__(self, "fault_check_matrix", fcm)
        object.__setattr__(self, "fault_map", fmap)
        object.__setattr__(self, "fault_priors", np.asarray(detector_model.priors))
