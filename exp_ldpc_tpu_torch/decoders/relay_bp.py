"""Relay (disordered-memory) BP ensemble in plain PyTorch.

Counterpart of ``exp_ldpc_tpu/decoders/relay_bp.py`` (arXiv:2507.00254):
``num_legs`` legs of ``iters_per_leg`` flooding iterations whose variable
update keeps a memory term,

    lambda_j(t) = (1 - gamma_j) * (prior_j + sum_i c2v_ij) + gamma_j * lambda_j(t-1),

with v2c = lambda[var] - c2v.  Leg 0 uses the uniform ``gamma0``; later legs
draw per-variable gammas uniformly from ``gamma_range`` with
``np.random.default_rng(seed)``, exactly as the JAX decoder draws them, so
both decode the same ensemble.  Message state carries over between legs;
each shot keeps the first leg whose hard decision satisfies its syndrome,
and a shot no leg solved reports the last leg's lambda.

The JAX module computes outside Pallas (XLA dense or gather routing), so
there is no TPU kernel to port: :func:`relay_core` is the check update of
:mod:`.bp` (``check_update_cm``) and the Tanner gather tables, on the
tables' device; its loop over legs stops once every shot has converged,
with one host read per leg.  On a CUDA device
:meth:`RelayBPDecoder.decode_tensors` runs kernel K10
(:mod:`.relay_cuda`, one launch a decode, each shot leaving at its solving
leg, nothing read back) wherever its route rule takes the shape, and
:func:`relay_core` elsewhere.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch
from scipy import sparse

from ..convert import TannerTables, tanner_tables
from ..utils.device import DeviceLike, resolve_device
from . import relay_cuda
from .bp import (BIG, DecoderBase, alpha_at, channel_priors, check_update_cm,
                 normalize_method, priors_to_llr, syndrome_ok)
from .tanner import TannerELL

__all__ = ["relay_core", "RelayBPDecoder", "relay_bp_decode_batch"]


def relay_core(tables: TannerTables, prior_llr: torch.Tensor, syndromes: torch.Tensor,
               gammas: torch.Tensor, method: str, num_legs: int, iters_per_leg: int,
               ms_scaling_factor: float):
    """syndromes (C, S) 0/1; gammas (num_legs, V) f32 memory strengths.

    Returns (hard (V, S) uint8, posterior (V, S) f32, converged (S,) bool,
    solved_leg (S,) int32: the leg that first satisfied the syndrome,
    ``num_legs`` where none did)."""
    method = normalize_method(method)
    t = tables
    C, V, Dc = t.num_checks, t.num_vars, t.max_check_degree
    S = syndromes.shape[1]
    dev = syndromes.device
    prior = prior_llr.to(device=dev, dtype=torch.float32)
    synd_sign = 1.0 - 2.0 * syndromes.to(torch.float32)
    mask3 = t.chk_mask[:, :, None]
    v2c = torch.where(t.chk_mask, prior[t.chk_vars], BIG)[:, :, None].expand(C, Dc, S)
    zero_row = torch.zeros((1, S), device=dev)
    lam = prior[:, None].expand(V, S)
    hard = torch.zeros((V, S), dtype=torch.uint8, device=dev)
    post = lam.clone()
    conv = torch.zeros(S, dtype=torch.bool, device=dev)
    solved = torch.full((S,), num_legs, dtype=torch.int32, device=dev)
    for leg in range(num_legs):
        if bool(conv.all()):
            break
        gamma = gammas[leg][:, None]
        for it in range(iters_per_leg):
            c2v = check_update_cm(v2c, synd_sign, method, alpha_at(it, ms_scaling_factor))
            g = torch.cat([c2v.reshape(C * Dc, S), zero_row])[t.vm_from_cm]     # (V, Dv, S)
            total = g[:, 0]
            for j in range(1, g.shape[1]):
                total = total + g[:, j]
            lam = (1.0 - gamma) * (prior[:, None] + total) + gamma * lam
            v2c = torch.where(mask3, lam[t.chk_vars] - c2v, BIG)
        hard_new = (lam <= 0).to(torch.uint8)
        newly = syndrome_ok(hard_new, syndromes, t) & ~conv
        hard = torch.where(newly[None], hard_new, hard)
        post = torch.where(newly[None], lam, post)
        solved = torch.where(newly, leg, solved)
        conv = conv | newly
    # shots never converged: the final leg's lambda and hard decision
    hard = torch.where(conv[None], hard, (lam <= 0).to(torch.uint8))
    post = torch.where(conv[None], post, lam)
    return hard, post, conv, solved


@dataclass
class RelayBPDecoder(DecoderBase):
    """Batched relay BP ensemble; ``decode_batch`` returns numpy (hard (S,
    V), posterior (S, V), converged (S,), solved leg (S,))."""

    tables: TannerTables
    prior_llr: np.ndarray
    method: str = "ms"
    num_legs: int = 8
    iters_per_leg: int = 30
    gamma0: float = 0.65
    gamma_range: Tuple[float, float] = (-0.25, 0.85)
    ms_scaling_factor: float = 1.0
    seed: int = 0
    _gammas: np.ndarray = field(init=False, repr=False)

    def __post_init__(self):
        self.method = normalize_method(self.method)
        rng = np.random.default_rng(self.seed)
        g = rng.uniform(self.gamma_range[0], self.gamma_range[1],
                        size=(self.num_legs, self.tables.num_vars))
        g[0, :] = self.gamma0
        self._gammas = g.astype(np.float32)
        dev = self.tables.device
        self._gammas_dev = torch.as_tensor(self._gammas).to(dev)
        self._prior = torch.as_tensor(np.asarray(self.prior_llr, dtype=np.float32)).to(dev)

    @property
    def device(self) -> torch.device:
        return self.tables.device

    @classmethod
    def from_check_matrix(cls, H, *, error_rate: Optional[float] = None,
                          channel_probs: Optional[np.ndarray] = None,
                          device: DeviceLike = "cuda", **kw) -> "RelayBPDecoder":
        tanner = TannerELL.from_check_matrix(sparse.csr_matrix(H))
        prior = channel_priors(tanner.num_vars, error_rate, channel_probs)
        return cls(tanner_tables(tanner, resolve_device(device)), priors_to_llr(prior), **kw)

    def decode_tensors(self, syndromes: torch.Tensor):
        """(C, S) device syndromes -> (hard, posterior, conv, solved leg)
        tensors: kernel K10 where :func:`.relay_cuda.takes` the decode, else
        :func:`relay_core`."""
        if relay_cuda.takes(self.tables, self.method, self.num_legs, syndromes.device):
            return relay_cuda.relay_decode(self.tables, self._prior, syndromes,
                                           self._gammas_dev, self.num_legs, self.iters_per_leg,
                                           float(self.ms_scaling_factor))
        return relay_core(self.tables, self._prior, syndromes, self._gammas_dev, self.method,
                          self.num_legs, self.iters_per_leg, float(self.ms_scaling_factor))


def relay_bp_decode_batch(H, syndromes, **kw):
    """One-call decode: ``RelayBPDecoder.from_check_matrix(H, **kw).decode_batch``."""
    return RelayBPDecoder.from_check_matrix(H, **kw).decode_batch(syndromes)
