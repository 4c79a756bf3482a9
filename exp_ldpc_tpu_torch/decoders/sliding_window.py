"""Sliding-window spacetime decoding: O(window) memory for any round count.

Counterpart of ``exp_ldpc_tpu/decoders/sliding_window.py``, the same
overlapping-window scheme:

  * the differenced spacetime syndrome (``SpacetimeCode`` convention:
    ``sigma_u = H e_u + m_{u-1} + m_u``) is processed in windows of ``w``
    round-blocks with stride ``c <= w`` (commit region);
  * the WINDOW matrix is ``SpacetimeCode(H, w-1)`` plus an open-boundary
    measurement column block ``[0; I_r]`` for the last in-window round (its
    partner row lies outside the window);
  * after decoding a window, only the first ``c`` data blocks are committed
    into the running correction ``acc``; the window then advances by ``c``
    rounds.  Only the FIRST in-window block depends on ``acc``
    (``sigma_0 = s_t + H acc``), so the rebase is one matrix product;
  * the tail (once the transversal readout is reachable within ``w``
    rounds) decodes on the exact final ``SpacetimeCode`` with the perfect
    readout round, so a window >= total rounds is the full spacetime decode.

Every window reuses one decoder on ``device``: BP+OSD (flat BP chosen by
:func:`.select.make_bp_decoder`: on a card kernel K1 with its exit per shot
block armed, as BP+OSD asks the exit; OSD on the host) or, with
``use_osd=False``,
:class:`.bp.BPDecoder` (per-shot freezing).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import scipy.sparse as sparse

from ..utils.device import DeviceLike, resolve_device
from .bp import BPDecoder
from .bposd import BPOSDDecoder
from .parity import mod2_matmul, spacetime_syndromes
from .spacetime import SpacetimeCode

__all__ = ["SlidingWindowDecoder", "window_check_matrix"]

# the options BPDecoder.from_check_matrix takes (BP+OSD takes the OSD ones too)
_BP_KEYS = ("max_iter", "bp_method", "ms_scaling_factor", "early_stop")


def window_check_matrix(check_matrix: sparse.spmatrix, window: int) -> sparse.spmatrix:
    """Open-boundary spacetime matrix for ``window`` noisy syndrome rounds.

    ``SpacetimeCode(H, window-1)`` covers rounds 0..window-1 with
    measurement columns between adjacent rounds; the appended ``[0; I_r]``
    block is the last round's own measurement error (whose second row block
    lives outside the window).
    """
    H = sparse.csr_matrix(check_matrix)
    r = H.shape[0]
    base = SpacetimeCode(H, window - 1).spacetime_check_matrix
    rows = base.shape[0]
    open_meas = sparse.vstack(
        [sparse.csr_matrix((rows - r, r), dtype=H.dtype),
         sparse.identity(r, dtype=H.dtype, format="csr")]
    )
    return sparse.hstack([base, open_meas]).tocsr()


@dataclass(eq=False)
class SlidingWindowDecoder:
    """Streaming multi-round decoder with bounded memory.

    ``decode_batch(history (S, rounds, r), readout (S, n)) -> (S, n)``
    final data correction, matching the contract of the full-matrix
    drivers.  ``window`` is the number of syndrome rounds decoded at once,
    ``commit`` the stride (defaults to ``window // 2``).
    """

    check_matrix: sparse.spmatrix
    data_prior: float
    meas_prior: float
    window: int = 4
    commit: Optional[int] = None
    bp_options: Dict = field(default_factory=dict)
    use_osd: bool = True
    device: DeviceLike = "cuda"

    def __post_init__(self):
        H = sparse.csr_matrix(self.check_matrix)
        self.check_matrix = H
        self.device = resolve_device(self.device)
        if self.commit is None:
            self.commit = max(1, self.window // 2)
        if not (1 <= self.commit <= self.window):
            raise ValueError("need 1 <= commit <= window")
        w = self.window
        r, n = H.shape
        self._r, self._n = r, n
        self._HdT = H.T.toarray()
        prior = np.concatenate([np.full(w * n, self.data_prior), np.full(w * r, self.meas_prior)])
        self._win_dec = self._decoder(window_check_matrix(H, w), prior)
        self._tail_cache: Dict[int, object] = {}

    def _decoder(self, H, prior):
        if self.use_osd:
            return BPOSDDecoder.from_check_matrix(H, channel_probs=prior, device=self.device,
                                                  **self.bp_options)
        opts = {k: v for k, v in self.bp_options.items() if k in _BP_KEYS}
        return BPDecoder.from_check_matrix(H, channel_probs=prior, device=self.device, **opts)

    def _tail_decoder(self, rounds: int):
        """Exact final-window decoder (perfect readout round) for ``rounds``
        remaining noisy rounds; cached per length."""
        if rounds not in self._tail_cache:
            st = SpacetimeCode(self.check_matrix, rounds)
            prior = np.concatenate(
                [np.full((rounds + 1) * self._n, self.data_prior),
                 np.full(rounds * self._r, self.meas_prior)])
            self._tail_cache[rounds] = (st, self._decoder(st.spacetime_check_matrix, prior))
        return self._tail_cache[rounds]

    @staticmethod
    def _correction(dec, syndromes: np.ndarray) -> np.ndarray:
        out = dec.decode_batch(syndromes)
        return np.asarray(out[0] if isinstance(out, tuple) else out)  # BPDecoder: (hard, ...)

    def decode_batch(self, history: np.ndarray, readout: np.ndarray) -> np.ndarray:
        """history: (S, rounds, r) raw per-round syndromes; readout: (S, n)."""
        history = np.asarray(history, dtype=np.int64)
        readout = np.asarray(readout, dtype=np.int64)
        S, rounds, r = history.shape
        n = self._n
        w, c = self.window, self.commit

        acc = np.zeros((S, n), dtype=np.int64)
        t = 0
        # stream interior windows while a full window of noisy rounds remains
        # BEFORE the readout can close the tail exactly
        while rounds - t > w:
            win = history[:, t:t + w, :].copy()
            win[:, 0, :] = (win[:, 0, :] + mod2_matmul(acc, self._HdT)) % 2
            # difference within the window (block 0 is already relative to
            # the committed state)
            win[:, 1:, :] = (win[:, 1:, :] + history[:, t:t + w - 1, :]) % 2
            correction = self._correction(self._win_dec, win.reshape(S, w * r))
            data = correction[:, : w * n].reshape(S, w, n).astype(np.int64)
            acc = (acc + data[:, :c, :].sum(axis=1)) % 2
            t += c

        # exact tail: remaining noisy rounds + perfect readout round.
        # Difference on RAW history/readout first (interior differences are
        # acc-free), then rebase ONLY block 0 onto the committed state
        tail_rounds = rounds - t
        st, dec = self._tail_decoder(tail_rounds)
        synd = spacetime_syndromes(st, history[:, t:, :], readout)
        synd[:, :r] = (synd[:, :r] + mod2_matmul(acc, self._HdT)) % 2
        final = st.final_correction(self._correction(dec, synd))
        return (final + acc) % 2
