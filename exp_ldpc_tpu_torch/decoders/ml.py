"""Exact maximum-likelihood decoding for tiny codes (accuracy anchor).

The framework's LER claims are otherwise validated only internally
(device-vs-oracle, sharded-vs-unsharded); this module pins them to GROUND
TRUTH: for codes small enough to enumerate every error pattern (n <= ~20),
the degeneracy-aware ML decoder computes the EXACT optimal correction, so

  * ``MLDecoder`` gives the information-theoretic best LER any decoder can
    reach — BP+OSD must land within a small factor of it at low p;
  * a wrong global convention anywhere in the chain (priors, syndrome
    direction, logical application) shifts measured LERs away from analytic
    truth and fails the anchors in ``tests/test_ml_anchor.py``.

No reference counterpart: the reference ships no decoder tests at all
(SURVEY.md §4 — ``misc/`` is untested there).

Degeneracy: a CSS code corrects an error class, not an error.  For each
syndrome the decoder sums the iid-error-channel probability over each coset
``e0 + rowspace(stabilizers) + logical class`` and picks the most probable
class representative — the true ML rule for independent X (or Z) errors.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy import sparse

__all__ = ["MLDecoder", "enumerate_cosets"]


def _bits_of(x: np.ndarray, n: int) -> np.ndarray:
    """(K,) uint64 -> (K, n) uint8 little-endian bit planes."""
    return ((x[:, None] >> np.arange(n, dtype=np.uint64)[None, :]) & 1).astype(np.uint8)


def _pack(rows: np.ndarray) -> np.ndarray:
    """(K, n) 0/1 -> (K,) uint64 (n <= 63)."""
    n = rows.shape[1]
    return (rows.astype(np.uint64) << np.arange(n, dtype=np.uint64)[None, :]).sum(
        axis=1, dtype=np.uint64)


def enumerate_cosets(H, L):
    """All 2^n errors grouped by (syndrome, logical class).

    Returns (synd_of (2^n,) int64, cls_of (2^n,) int64, weight (2^n,) uint8)
    where syndrome/class ids are the packed bit patterns ``H e`` / ``L e``.
    """
    H = sparse.csr_matrix(H).toarray() % 2
    L = np.asarray(L) % 2
    r, n = H.shape
    if n > 22:
        raise ValueError(f"n={n} too large for exact enumeration")
    errs = _bits_of(np.arange(1 << n, dtype=np.uint64), n)  # (2^n, n)
    synd_of = _pack(errs @ H.T % 2)
    cls_of = _pack(errs @ L.T % 2)
    weight = errs.sum(axis=1).astype(np.uint8)
    return synd_of.astype(np.int64), cls_of.astype(np.int64), weight


@dataclass
class MLDecoder:
    """Degeneracy-aware exact ML decoder for one CSS sector.

    ``decode_batch`` returns corrections whose logical class maximizes the
    total coset probability under iid flip probability ``p`` (the same
    channel the storage experiments use for data errors).
    """

    H: np.ndarray
    L: np.ndarray
    p: float

    def __post_init__(self):
        H = sparse.csr_matrix(self.H).toarray() % 2
        L = np.asarray(self.L) % 2
        self.H, self.L = H, L
        r, n = H.shape
        k = L.shape[0]
        synd_of, cls_of, weight = enumerate_cosets(H, L)
        # coset probability: sum over errors of p^w (1-p)^(n-w), keyed by
        # (syndrome, class)
        pw = (self.p ** weight.astype(np.float64)
              * (1 - self.p) ** (n - weight.astype(np.float64)))
        n_synd, n_cls = 1 << r, 1 << k
        prob = np.zeros((n_synd, n_cls))
        np.add.at(prob, (synd_of, cls_of), pw)
        best_cls = prob.argmax(axis=1)  # (n_synd,)
        # one minimum-weight representative per (syndrome, class): sort by
        # (key, weight), unique keeps the lightest error of each coset
        key = synd_of * n_cls + cls_of
        order = np.lexsort((weight, key))
        uniq_key, first_idx = np.unique(key[order], return_index=True)
        rep = np.full(n_synd * n_cls, -1, dtype=np.int64)
        rep[uniq_key] = order[first_idx]
        rep = rep.reshape(n_synd, n_cls)
        self._correction_of_synd = rep[np.arange(n_synd), best_cls]
        self._ml_class = best_cls
        self._num_bits = n

    def decode_batch(self, syndromes: np.ndarray) -> np.ndarray:
        """(S, r) syndromes -> (S, n) ML corrections."""
        syndromes = np.asarray(syndromes) % 2
        sid = _pack(syndromes).astype(np.int64)
        packed = self._correction_of_synd[sid]
        if (packed < 0).any():
            raise ValueError("syndrome outside the code's syndrome space")
        return _bits_of(packed.astype(np.uint64), self._num_bits)

    def logical_error_rate(self, shots: int, seed: int = 0,
                           decoder=None) -> float:
        """Monte-Carlo LER of ``decoder`` (default: self) under iid flips.

        ``decoder`` must map an (S, r) syndrome batch to (S, n) corrections;
        a logical failure is a corrected error outside the stabilizer group.
        """
        rng = np.random.default_rng(seed)
        errs = (rng.random((shots, self.H.shape[1])) < self.p).astype(np.uint8)
        synd = errs @ self.H.T % 2
        corr = (self.decode_batch(synd) if decoder is None
                else np.asarray(decoder(synd)))
        resid = (errs + corr) % 2
        flips = resid @ self.L.T % 2
        return float(np.any(flips != 0, axis=1).mean())
