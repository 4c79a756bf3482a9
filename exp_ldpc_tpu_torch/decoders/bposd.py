"""BP+OSD: batched device BP with host OSD on the BP failures.

Counterpart of ``exp_ldpc_tpu/decoders/bposd.py``: BP runs on the BP
stage's device; the shots whose BP estimate does not reproduce the syndrome
get OSD post-processing on their BP soft output, on the host, through the
JAX package's JAX-free ``osd_decode_batch`` (threaded C++ kernel).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
from scipy import sparse

from ..utils.device import DeviceLike
from ..utils.observability import count, span
from .osd import osd_decode_batch

__all__ = ["BPOSDDecoder"]


@dataclass
class BPOSDDecoder:
    bp: object   # BPDecoder | BSRBPDecoder | SpacetimeBPDecoder | SpacetimeBSRDecoder
    H: sparse.csr_matrix
    osd_method: str = "osd_cs"
    osd_order: int = 7

    @classmethod
    def from_check_matrix(cls, H, *, error_rate: Optional[float] = None,
                          channel_probs: Optional[np.ndarray] = None, max_iter: int = 0,
                          bp_method: str = "ps", ms_scaling_factor: float = 0.0,
                          osd_method: str = "osd_cs", osd_order: int = 7, qc_dims=None,
                          qc_check_perm=None, qc_var_perm=None,
                          device: DeviceLike = "cuda") -> "BPOSDDecoder":
        """Flat BP chosen by :func:`.select.make_bp_decoder` with the early
        exit (kernel K1 on a CUDA device), OSD on ``H`` in the original
        column order."""
        from .select import make_bp_decoder

        bp = make_bp_decoder(H, error_rate=error_rate, channel_probs=channel_probs,
                             max_iter=max_iter, bp_method=bp_method,
                             ms_scaling_factor=ms_scaling_factor, qc_dims=qc_dims,
                             qc_check_perm=qc_check_perm, qc_var_perm=qc_var_perm,
                             device=device)
        return cls(bp=bp, H=sparse.csr_matrix(H), osd_method=osd_method, osd_order=osd_order)

    def decode_batch(self, syndromes: np.ndarray) -> np.ndarray:
        """(S, C) syndromes -> (S, V) error estimates (BP, OSD on BP failures)."""
        syndromes = np.asarray(syndromes, dtype=np.uint8)
        with span("redecode.bp"):
            hard, post, conv, _iters = self.bp.decode_batch(syndromes)
        hard = hard.copy()
        if not conv.all():
            failed = np.nonzero(~conv)[0]
            count("osd_solves", failed.size)
            hard[failed] = osd_decode_batch(
                self.H, syndromes[failed], post[failed],
                osd_method=self.osd_method, osd_order=self.osd_order)
        return hard
