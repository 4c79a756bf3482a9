"""BP+OSD: batched device BP with host OSD on the BP failures.

Counterpart of ``exp_ldpc_tpu/decoders/bposd.py``: BP runs on the BP
stage's device; the shots whose BP estimate does not reproduce the syndrome
get OSD post-processing on their BP soft output, on the host, through the
JAX package's JAX-free ``osd_decode_batch`` (threaded C++ kernel).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy import sparse

from .. import _host

__all__ = ["BPOSDDecoder"]


@dataclass
class BPOSDDecoder:
    bp: object               # SpacetimeBPDecoder | SpacetimeBSRDecoder
    H: sparse.csr_matrix
    osd_method: str = "osd_cs"
    osd_order: int = 7

    def decode_batch(self, syndromes: np.ndarray) -> np.ndarray:
        """(S, C) syndromes -> (S, V) error estimates (BP, OSD on BP failures)."""
        syndromes = np.asarray(syndromes, dtype=np.uint8)
        hard, post, conv, _iters = self.bp.decode_batch(syndromes)
        hard = hard.copy()
        if not conv.all():
            failed = np.nonzero(~conv)[0]
            hard[failed] = _host.osd_decode_batch(
                self.H, syndromes[failed], post[failed],
                osd_method=self.osd_method, osd_order=self.osd_order)
        return hard
