"""Quantized (int8) min-sum BP in plain PyTorch.

Counterpart of ``exp_ldpc_tpu/decoders/bp_int8.py``: messages are int8
fixed-point LLRs, sums are int32, and the min-sum scaling is the exact
rational ``alpha_num / 2**8``, so a whole iteration is integer arithmetic
and every implementation of it (this module, its numpy oracle, the JAX
package's ``_int8_bp_core`` and the int8 kernel K5 of :mod:`.bp_bsr`) gives
the same bits in fixed-iteration mode.

Where the JAX version routes messages through int8 one-hot matrix
products, :func:`int8_bp_core` gathers through the ``TannerELL`` tables;
integer sums do not depend on their order, so the results are equal.

Semantics mirror :mod:`.bp`: per-column priors, early stop that freezes
each shot at its first convergence, min-sum with a fixed scaling factor.
Sum-product is not offered (phi has no useful fixed-point form at this
width).

Quantization: LLRs are divided by ``delta = max(prior_llr) /
prior_quanta`` so the largest prior maps to ``prior_quanta`` (default 24)
quanta.  Messages saturate at +-127 by an explicit clamp; the variable
update excludes self against the SATURATED posterior, as fixed-point
decoders do.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from scipy import sparse

from ..convert import TannerTables, tanner_tables
from ..utils.device import DeviceLike, resolve_device
from .bp import DecoderBase, channel_priors, check_parity, priors_to_llr
from .tanner import TannerELL

__all__ = ["SAT", "ALPHA_SHIFT", "quantize_priors", "alpha_num_of", "check_update_int",
           "int8_bp_core", "int8_bp_oracle", "Int8BPDecoder"]

SAT = 127        # saturation magnitude; -128 occurs only where the reference wraps
ALPHA_SHIFT = 8  # min-sum scaling as alpha_num / 2**8


def quantize_priors(prior_llr: np.ndarray, prior_quanta: int = 24):
    """LLR priors -> (int32 quanta, delta).  delta = LLR units per quantum."""
    prior_llr = np.asarray(prior_llr, dtype=np.float64)
    delta = float(prior_llr.max()) / float(prior_quanta)
    if delta <= 0:
        raise ValueError("priors must contain a positive LLR")
    q = np.clip(np.rint(prior_llr / delta), -SAT, SAT).astype(np.int32)
    return q, delta


def alpha_num_of(ms_scaling_factor: float) -> int:
    """The scaling factor as a numerator over 2**8."""
    return int(round(ms_scaling_factor * (1 << ALPHA_SHIFT)))


def check_update_int(v2c: torch.Tensor, synd: torch.Tensor, alpha_num: int) -> torch.Tensor:
    """Min-sum check update on int8 messages in check-major (C, Dc, S).

    ``synd`` is (C, S) int32 of 0/1.  Padded slots hold +SAT (sign +, never
    below a live minimum).  The first slot that attains the minimum
    receives the second minimum, which for a check of one slot is SAT + 1
    (and wraps to -128 in the int8 cast when ``alpha_num`` is 256, as in
    the reference).  Returns int8 c2v; padded output slots are never read.
    """
    neg = v2c < 0
    mag = v2c.to(torch.int32).abs()
    negi = neg.to(torch.int32)
    total_neg = (negi.sum(dim=1, keepdim=True, dtype=torch.int32) + synd[:, None, :]) % 2
    ext_neg = (total_neg + negi) % 2 == 1                 # sign parity excluding self
    min1 = mag.min(dim=1, keepdim=True).values
    hit = mag == min1
    is_min = hit & (torch.cumsum(hit.to(torch.int32), dim=1) == 1)
    min2 = torch.where(is_min, SAT + 1, mag).min(dim=1, keepdim=True).values
    ext = torch.where(is_min, min2, min1)
    scaled = (ext * int(alpha_num)) >> ALPHA_SHIFT        # exact rational scaling
    return torch.where(ext_neg, -scaled, scaled).to(torch.int8)


def int8_step(t: TannerTables, v2c: torch.Tensor, synd: torch.Tensor, prior_q: torch.Tensor,
              alpha_num: int):
    """One flooding iteration: v2c (C, Dc, S) int8 -> (new v2c int8,
    posterior (V, S) int32 quanta)."""
    C, Dc, S = v2c.shape
    c2v = check_update_int(v2c, synd, alpha_num).to(torch.int32)
    zero_row = torch.zeros((1, S), dtype=torch.int32, device=v2c.device)
    c2v_vm = torch.cat([c2v.reshape(C * Dc, S), zero_row])[t.vm_from_cm]    # (V, Dv, S)
    totals = c2v_vm.sum(dim=1, dtype=torch.int32)
    posterior = prior_q[:, None] + totals                 # unsaturated int32
    post8 = posterior.clamp(-SAT, SAT)
    v2c_new = (post8[t.chk_vars] - c2v).clamp(-SAT, SAT)
    v2c_new = torch.where(t.chk_mask[:, :, None], v2c_new, SAT).to(torch.int8)
    return v2c_new, posterior


def int8_v2c0(t: TannerTables, prior_q: torch.Tensor, S: int) -> torch.Tensor:
    """Initial messages (C, Dc, S) int8: the saturated prior of each edge's
    variable, +SAT on a padded slot."""
    edge = torch.where(t.chk_mask, prior_q.clamp(-SAT, SAT)[t.chk_vars], SAT).to(torch.int8)
    return edge[:, :, None].expand(*edge.shape, S).contiguous()


def int8_syndrome_ok(posterior: torch.Tensor, synd: torch.Tensor, t: TannerTables):
    """(S,) bool: the hard decision of ``posterior`` (V, S) reproduces ``synd``."""
    return (check_parity((posterior <= 0).to(torch.uint8), t) == synd).all(dim=0)


def int8_bp_core(tables: TannerTables, prior_q: torch.Tensor, syndromes: torch.Tensor,
                 max_iter: int, alpha_num: int, early_stop: bool = True):
    """syndromes (C, S) 0/1; prior_q (V,) int32 quanta.  Returns (hard
    (V, S) uint8, posterior (V, S) int32 quanta, converged (S,) bool, iters
    (S,) int32), on the tensors' device.  ``early_stop`` freezes each shot
    at its first convergence and stops once all have converged."""
    t = tables
    V = t.num_vars
    S = syndromes.shape[1]
    dev = syndromes.device
    synd = syndromes.to(torch.int32)
    prior_q = prior_q.to(device=dev, dtype=torch.int32)
    v2c = int8_v2c0(t, prior_q, S)
    posterior = prior_q[:, None].expand(V, S)
    if not early_stop:
        for _ in range(max_iter):
            v2c, posterior = int8_step(t, v2c, synd, prior_q, alpha_num)
        hard = (posterior <= 0).to(torch.uint8)
        return (hard, posterior.contiguous(), int8_syndrome_ok(posterior, synd, t),
                torch.full((S,), max_iter, dtype=torch.int32, device=dev))
    hard = torch.zeros((V, S), dtype=torch.uint8, device=dev)
    post = posterior.clone()
    conv = torch.zeros(S, dtype=torch.bool, device=dev)
    iters = torch.zeros(S, dtype=torch.int32, device=dev)
    it = 0
    while it < max_iter and not bool(conv.all()):
        v2c, posterior = int8_step(t, v2c, synd, prior_q, alpha_num)
        ok = int8_syndrome_ok(posterior, synd, t)
        hard = torch.where(conv[None], hard, (posterior <= 0).to(torch.uint8))
        post = torch.where(conv[None], post, posterior)
        iters = torch.where(conv, iters, it + 1)
        conv = conv | ok
        it += 1
    return hard, post, conv, iters


def int8_bp_oracle(H, prior_q, syndromes, max_iter: int, alpha_num: int):
    """numpy mirror of :func:`int8_bp_core` (fixed-iteration path), in
    int64 throughout: equal to it bit for bit wherever no message leaves
    the int8 range (everywhere but a one-slot check at ``alpha_num`` 256)."""
    tanner = TannerELL.from_check_matrix(H)
    C, V, Dc = tanner.num_checks, tanner.num_vars, tanner.max_check_degree
    syndromes = np.asarray(syndromes, dtype=np.int64)  # (C, S)
    S = syndromes.shape[1]
    chk_vars, chk_mask = tanner.chk_vars, tanner.chk_mask
    prior_q = np.asarray(prior_q, dtype=np.int64)
    Hd = sparse.csr_matrix(H).toarray().astype(np.int64)

    edge_prior = np.clip(prior_q, -SAT, SAT)[chk_vars]
    v2c = np.where(chk_mask, edge_prior, SAT)[:, :, None] * np.ones((1, 1, S), dtype=np.int64)
    posterior = np.broadcast_to(prior_q[:, None], (V, S)).copy()

    for _ in range(max_iter):
        neg = v2c < 0
        mag = np.abs(v2c)
        total_neg = (neg.sum(axis=1, keepdims=True) + syndromes[:, None, :]) % 2
        ext_neg = (total_neg + neg) % 2 == 1
        min1 = mag.min(axis=1, keepdims=True)
        is_min = (mag == min1) & (np.cumsum(mag == min1, axis=1) == 1)
        min2 = np.where(is_min, SAT + 1, mag).min(axis=1, keepdims=True)
        ext = np.where(is_min, min2, min1)
        scaled = (ext * alpha_num) >> ALPHA_SHIFT
        c2v = np.where(ext_neg, -scaled, scaled)
        c2v = np.where(chk_mask[:, :, None], c2v, 0)  # padded slots add nothing

        totals = np.zeros((V, S), dtype=np.int64)
        np.add.at(totals, chk_vars.reshape(-1), c2v.reshape(C * Dc, S))
        posterior = prior_q[:, None] + totals
        post8 = np.clip(posterior, -SAT, SAT)
        v2c = np.clip(post8[chk_vars] - c2v, -SAT, SAT)
        v2c = np.where(chk_mask[:, :, None], v2c, SAT)

    hard = (posterior <= 0).astype(np.uint8)
    conv = ((Hd @ hard) % 2 == syndromes).all(axis=0)
    return hard, posterior, conv


@dataclass
class Int8BPDecoder(DecoderBase):
    """Quantized min-sum BP with the ``BPDecoder`` decode contract; the
    posterior is returned in LLR units (quanta * delta), so an OSD stage
    after it ranks on the usual scale."""

    tables: TannerTables
    prior_q: np.ndarray
    delta: float
    max_iter: int = 0
    ms_scaling_factor: float = 0.625
    early_stop: bool = True

    def __post_init__(self):
        if self.max_iter <= 0:
            self.max_iter = self.tables.num_vars
        if not 0 < self.ms_scaling_factor <= 1:
            raise ValueError("int8 BP needs a fixed scaling factor in (0, 1]")
        self._prior_q = torch.as_tensor(np.asarray(self.prior_q, dtype=np.int32)).to(
            self.tables.device)

    @property
    def device(self) -> torch.device:
        return self.tables.device

    @property
    def alpha_num(self) -> int:
        return alpha_num_of(self.ms_scaling_factor)

    @classmethod
    def from_check_matrix(cls, H, *, error_rate: Optional[float] = None,
                          channel_probs: Optional[np.ndarray] = None, max_iter: int = 0,
                          ms_scaling_factor: float = 0.625, early_stop: bool = True,
                          prior_quanta: int = 24, device: DeviceLike = "cuda",
                          **_ignored) -> "Int8BPDecoder":
        tanner = TannerELL.from_check_matrix(sparse.csr_matrix(H))
        prior = channel_priors(tanner.num_vars, error_rate, channel_probs)
        q, delta = quantize_priors(priors_to_llr(prior), prior_quanta)
        return cls(tanner_tables(tanner, resolve_device(device)), q, delta, max_iter,
                   float(ms_scaling_factor), early_stop)

    def decode_tensors(self, syndromes: torch.Tensor):
        """(C, S) device syndromes -> (hard, posterior in LLR units, conv, iters)."""
        hard, post, conv, iters = int8_bp_core(self.tables, self._prior_q, syndromes,
                                               self.max_iter, self.alpha_num, self.early_stop)
        return hard, post.to(torch.float32) * self.delta, conv, iters
