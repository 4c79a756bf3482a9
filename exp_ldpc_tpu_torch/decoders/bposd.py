"""BP+OSD: batched device BP with OSD on the BP failures.

Counterpart of ``exp_ldpc_tpu/decoders/bposd.py``: BP runs on the BP
stage's device; the shots whose BP estimate does not reproduce the syndrome
get OSD post-processing on their BP soft output.  Where the BP stage runs
on a CUDA card and :func:`.osd_cuda.takes` the shape, method and order,
that OSD is kernel K8 on the card (:func:`.osd_cuda.osd_solve`, a block a
shot, the matrix in shared memory or, past a block's shared memory, in
device memory); everything else runs on the host, through the JAX
package's JAX-free ``osd_decode_batch`` (threaded C++ kernel, K8's plain
version).  :meth:`BPOSDDecoder.decode_tensors` takes and returns tensors on
the BP stage's device; :meth:`BPOSDDecoder.decode_batch` is its numpy
wrapper.
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
    bp: DecoderBase   # BPDecoder | BSRBPDecoder | SpacetimeBPDecoder | SpacetimeBSRDecoder
    H: sparse.csr_matrix
    osd_method: str = "osd_cs"
    osd_order: int = 7
    # H's columns on the card where K8 serves this decoder, False where it
    # does not; None until the first OSD decides
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
            dev = self.bp.device
            self._route = osd_cuda.card_route(self.H.shape, self.osd_method, self.osd_order, dev)
            self._card = self._route is not None and osd_cuda.card_matrix(self.H, dev)
        return self._card or None

    def decode_tensors(self, syndromes: torch.Tensor):
        """(C, S) uint8 syndromes on the BP stage's device -> (hard (V, S),
        conv (S,) bool) there: BP's hard decisions, OSD's answer in place of
        each shot BP left unconverged (conv false)."""
        with span("redecode.bp"):
            hard, post, conv, _iters = self.bp.decode_tensors(syndromes)
            failed = torch.nonzero(~conv).flatten()
        if not failed.numel():
            return hard, conv
        count("osd_solves", failed.numel())
        synd, llr = syndromes.T[failed].contiguous(), post.T[failed]
        mat = self._card_matrix()
        if mat is None:   # the C++ path, on the host
            out = torch.as_tensor(osd_decode_batch(
                self.H, synd.cpu().numpy(), llr.cpu().numpy(), osd_method=self.osd_method,
                osd_order=self.osd_order))
        else:
            with span("redecode.osd"):
                if self._route == "device":
                    count("osd_device_solves", failed.numel())
                out = osd_cuda.osd_solve(mat, synd, llr.to(torch.float64).contiguous(),
                                         self.osd_method, self.osd_order)
        return hard.index_copy(1, failed, out.T.to(hard.device, hard.dtype)), conv

    def decode_batch(self, syndromes: np.ndarray) -> np.ndarray:
        """(S, C) syndromes -> (S, V) error estimates (BP, OSD on BP failures)."""
        s = torch.as_tensor(np.ascontiguousarray(np.asarray(syndromes, dtype=np.uint8).T))
        return self.decode_tensors(s.to(self.bp.device))[0].T.cpu().numpy()
