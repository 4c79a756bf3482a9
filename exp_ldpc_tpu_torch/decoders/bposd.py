"""BP+OSD: batched device BP with OSD on the BP failures.

Counterpart of ``exp_ldpc_tpu/decoders/bposd.py``: BP runs on the BP
stage's device; the shots whose BP estimate does not reproduce the syndrome
get OSD post-processing on their BP soft output.  Where the BP stage runs
on a CUDA card and :func:`.osd_cuda.takes` the shape, method and order,
that OSD is kernel K8 on the card (:func:`.osd_cuda.osd_solve`, a block a
shot, the matrix in shared memory or, past a block's shared memory, in
device memory: the posteriors and syndromes stay there, the corrections
come back in one copy); everything else runs on the host, through the JAX
package's JAX-free ``osd_decode_batch`` (threaded C++ kernel, K8's plain
version).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
from scipy import sparse

from ..utils.device import DeviceLike
from ..utils.observability import count, span
from . import osd_cuda
from .bp import DecoderBase
from .osd import osd_decode_batch

__all__ = ["BPOSDDecoder"]


@dataclass
class BPOSDDecoder:
    bp: object   # BPDecoder | BSRBPDecoder | SpacetimeBPDecoder | SpacetimeBSRDecoder
    H: sparse.csr_matrix
    osd_method: str = "osd_cs"
    osd_order: int = 7
    # H's columns on the card where K8 serves this decoder, False where it
    # does not; None until the first decode decides
    _card: object = field(default=None, init=False, repr=False, compare=False)
    # K8's route where it serves ("block" or "device")
    _route: Optional[str] = field(default=None, init=False, repr=False, compare=False)

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

    def _card_matrix(self):
        """H's columns on the BP stage's card where K8 takes this decoder's
        OSD (:func:`.osd_cuda.card_route`), else None."""
        if self._card is None:
            dev = getattr(self.bp, "device", None)
            self._route = (osd_cuda.card_route(self.H.shape, self.osd_method, self.osd_order,
                                               dev)
                           if isinstance(self.bp, DecoderBase) and dev is not None else None)
            self._card = self._route is not None and osd_cuda.card_matrix(self.H, dev)
        return self._card or None

    def decode_batch(self, syndromes: np.ndarray) -> np.ndarray:
        """(S, C) syndromes -> (S, V) error estimates (BP, OSD on BP failures)."""
        syndromes = np.asarray(syndromes, dtype=np.uint8)
        mat = self._card_matrix()
        if mat is not None:
            return self._decode_on_card(syndromes, mat)
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

    def _decode_on_card(self, syndromes: np.ndarray, mat) -> np.ndarray:
        """:meth:`decode_batch` with the BP failures' OSD on K8: the BP
        stage's posteriors and syndromes stay on the card."""
        with span("redecode.bp"):
            synd = torch.as_tensor(np.ascontiguousarray(syndromes.T)).to(mat.colptr.device)
            hard, post, conv, _iters = self.bp.decode_tensors(synd)
            failed = torch.nonzero(~conv).flatten()
            hard = hard.T.contiguous().cpu().numpy()
        if failed.numel():
            count("osd_solves", failed.numel())
            with span("redecode.osd"):
                count("osd_card_solves", failed.numel())
                if self._route == "device":
                    count("osd_device_solves", failed.numel())
                out = osd_cuda.osd_solve(mat, synd.T[failed].contiguous(),
                                         post.T[failed].to(torch.float64).contiguous(),
                                         self.osd_method, self.osd_order)
                hard[failed.cpu().numpy()] = out.cpu().numpy()
        return hard
