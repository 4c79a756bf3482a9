"""Batched flat belief propagation in plain PyTorch.

Counterpart of ``exp_ldpc_tpu/decoders/bp.py``: channel priors to LLRs,
the phi transform of sum-product, the check-node update in the check-major
``(C, D, S)`` layout (shots on the last axis), the flooding decoder
:func:`bp_core` (the counterpart of ``_bp_core``), :class:`BPDecoder` and
:func:`bp_decode_batch`.

:func:`bp_core` runs the gather form: c2v messages go to the
variable-major layout through ``TannerELL.vm_from_cm``, each variable sums
its messages left to right in that order and then adds its prior, and the
new v2c messages come back through ``cm_from_vm``.  Sums over a check's
slots are also taken left to right, so the CUDA kernels (which loop over
slots and edges in the same order) reproduce them exactly.  With
``early_stop=False`` it is the plain version of kernel K6
(:mod:`.bp_cuda`); per-shot-freezing early stop has no kernel.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from scipy import sparse

from ..convert import TannerTables, tanner_tables
from ..utils.device import DeviceLike, resolve_device
from .tanner import TannerELL

__all__ = ["BIG", "priors_to_llr", "phi", "check_update_cm", "normalize_method",
           "alpha_at", "dense_ops_bytes", "bp_core", "check_parity", "syndrome_ok", "BPDecoder",
           "bp_decode_batch", "channel_priors", "DecoderBase"]

BIG = 1e30
_PHI_CLAMP_LO = 1e-7
_PHI_CLAMP_HI = 30.0


def priors_to_llr(priors) -> np.ndarray:
    """Per-column error probabilities -> LLR log((1-p)/p), float32."""
    p = np.clip(np.asarray(priors, dtype=np.float64), 1e-12, 1 - 1e-12)
    return np.log((1 - p) / p).astype(np.float32)


def normalize_method(method: str) -> str:
    """ldpc method names -> "ps" | "ms" (``psl``/``msl`` are aliases)."""
    m = {"ps": "ps", "psl": "ps", "ms": "ms", "msl": "ms"}.get(method)
    if m is None:
        raise ValueError(f"unknown bp method {method!r}")
    return m


def alpha_at(it: int, ms_scaling_factor: float) -> float:
    """Min-sum scaling of iteration ``it`` (0-based) as an exact float32
    value: the fixed factor, or the adaptive 1 - 2^-(it+1) when it is 0."""
    if float(ms_scaling_factor) == 0.0:
        return float(np.float32(1.0 - 2.0 ** -(it + 1)))
    return float(np.float32(ms_scaling_factor))


def dense_ops_bytes(num_vars: int, num_checks: int, max_check_degree: int) -> int:
    """Bytes of the JAX package's dense one-hot routing operands for a base
    code (``exp_ldpc_tpu/decoders/bp.py:115-116``); the kernel-selection
    rule in :mod:`.select` is stated in this unit."""
    return 2 * 4 * num_vars * num_checks * max_check_degree


def phi(x: torch.Tensor) -> torch.Tensor:
    """phi(x) = -log(tanh(x/2)), self-inverse on (0, inf), clamped."""
    x = x.clamp(_PHI_CLAMP_LO, _PHI_CLAMP_HI)
    return -torch.log(torch.tanh(x * 0.5))


def _slot_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over axis 1, left to right."""
    total = x[:, 0]
    for i in range(1, x.shape[1]):
        total = total + x[:, i]
    return total


def check_update_cm(v2c_cm: torch.Tensor, synd_sign: torch.Tensor, method: str,
                    alpha: float) -> torch.Tensor:
    """Check-node update, elementwise in check-major layout.

    v2c_cm: (C, D, S) f32 with padded slots = +BIG; synd_sign: (C, S) of
    +-1.  Returns c2v in the same layout (padded slots hold values that are
    never read).  ``ps`` is sum-product in sign/phi form; ``ms`` is min-sum
    with scaling ``alpha`` (ties go to the first slot holding the minimum).
    """
    sign = torch.where(v2c_cm < 0, -1.0, 1.0)
    mag = v2c_cm.abs()
    total_sign = torch.prod(sign, dim=1, keepdim=True) * synd_sign[:, None, :]
    ext_sign = total_sign * sign
    if method == "ps":
        ph = phi(mag)
        total = _slot_sum(ph)[:, None, :]
        return ext_sign * phi(total - ph)
    min1 = mag.min(dim=1, keepdim=True).values
    hit = mag == min1
    is_min = hit & (torch.cumsum(hit.to(torch.int32), dim=1) == 1)
    min2 = torch.where(is_min, BIG, mag).min(dim=1, keepdim=True).values
    return ext_sign * torch.where(is_min, min2, min1) * alpha


def check_parity(hard: torch.Tensor, t: TannerTables) -> torch.Tensor:
    """(..., V, S) 0/1 -> (..., C, S) int32 parity of each check's bits."""
    bits = hard[..., t.chk_vars, :].to(torch.int32)                      # (..., C, Dc, S)
    return torch.where(t.chk_mask[:, :, None], bits, 0).sum(dim=-2) % 2


def syndrome_ok(hard: torch.Tensor, syndromes: torch.Tensor, t: TannerTables) -> torch.Tensor:
    """(S,) bool: H @ hard (V, S) equals ``syndromes`` (C, S) mod 2."""
    return (check_parity(hard, t) == syndromes.to(torch.int32)).all(dim=0)


def bp_core(tables: TannerTables, prior_llr: torch.Tensor, syndromes: torch.Tensor,
            method: str, max_iter: int, ms_scaling_factor: float, early_stop: bool = True):
    """Flooding BP on the tensors' device.

    prior_llr: (V,) f32 LLRs; syndromes: (C, S) 0/1.  Returns (hard (V, S)
    uint8, posterior (V, S) f32, converged (S,) bool, iters (S,) int32).
    ``early_stop`` freezes each shot at its first convergence (ldpc
    semantics) and stops once every shot has converged; without it every
    shot runs ``max_iter`` iterations and ``converged`` is the final
    syndrome check.
    """
    method = normalize_method(method)
    t = tables
    C, V, Dc, Dv = t.num_checks, t.num_vars, t.max_check_degree, t.max_var_degree
    S = syndromes.shape[1]
    dev = syndromes.device
    prior = prior_llr.to(device=dev, dtype=torch.float32)
    synd_sign = 1.0 - 2.0 * syndromes.to(torch.float32)
    edge_prior = torch.where(t.chk_mask, prior[t.chk_vars], BIG)            # (C, Dc)
    v2c0 = edge_prior[:, :, None].expand(C, Dc, S).contiguous()
    zero_row = torch.zeros((1, S), device=dev)
    big_row = torch.full((1, S), BIG, device=dev)

    def step(it, v2c):
        c2v = check_update_cm(v2c, synd_sign, method, alpha_at(it, ms_scaling_factor))
        c2v_vm = torch.cat([c2v.reshape(C * Dc, S), zero_row])[t.vm_from_cm]  # (V, Dv, S)
        totals = c2v_vm[:, 0]
        for j in range(1, Dv):
            totals = totals + c2v_vm[:, j]
        posterior = prior[:, None] + totals
        v2c_vm = posterior[:, None] - c2v_vm
        return torch.cat([v2c_vm.reshape(V * Dv, S), big_row])[t.cm_from_vm], posterior

    posterior = prior[:, None].expand(V, S)
    if not early_stop:
        v2c = v2c0
        for it in range(max_iter):
            v2c, posterior = step(it, v2c)
        hard = (posterior <= 0).to(torch.uint8)
        conv = syndrome_ok(hard, syndromes, t)
        return hard, posterior, conv, torch.full((S,), max_iter, dtype=torch.int32, device=dev)

    hard = torch.zeros((V, S), dtype=torch.uint8, device=dev)
    post = posterior.clone()
    conv = torch.zeros(S, dtype=torch.bool, device=dev)
    iters = torch.zeros(S, dtype=torch.int32, device=dev)
    v2c = v2c0
    it = 0
    while it < max_iter and not bool(conv.all()):
        v2c, posterior = step(it, v2c)
        hard_new = (posterior <= 0).to(torch.uint8)
        ok = syndrome_ok(hard_new, syndromes, t)
        # freeze each shot's outputs at its first convergence
        hard = torch.where(conv[None], hard, hard_new)
        post = torch.where(conv[None], post, posterior)
        iters = torch.where(conv, iters, it + 1)
        conv = conv | ok
        it += 1
    return hard, post, conv, iters


def channel_priors(num_vars: int, error_rate: Optional[float],
                   channel_probs: Optional[np.ndarray]) -> np.ndarray:
    """Per-column error probabilities from a vector or a scalar rate."""
    if channel_probs is not None:
        prior = np.asarray(channel_probs, dtype=np.float64)
        if prior.shape != (num_vars,):
            raise ValueError(f"channel_probs must have shape ({num_vars},)")
        return prior
    if error_rate is not None:
        return np.full(num_vars, error_rate, dtype=np.float64)
    raise ValueError("must supply error_rate or channel_probs")


class DecoderBase:
    """The numpy interface every decoder of the port shares: ``decode_batch``
    takes (S, C) syndromes and returns numpy (hard (S, V), posterior (S, V),
    converged (S,), iters (S,)); a subclass supplies :meth:`decode_tensors`
    on (C, S) device syndromes and the ``device`` property."""

    def decode_tensors(self, syndromes: torch.Tensor):
        raise NotImplementedError

    def decode_batch(self, syndromes: np.ndarray):
        s = torch.as_tensor(np.ascontiguousarray(np.asarray(syndromes, dtype=np.uint8).T))
        hard, post, conv, iters = self.decode_tensors(s.to(self.device))
        return (hard.T.cpu().numpy(), post.T.cpu().numpy(),
                conv.cpu().numpy(), iters.cpu().numpy())

    def decode(self, syndrome: np.ndarray) -> np.ndarray:
        """Single-shot convenience wrapper."""
        return self.decode_batch(np.asarray(syndrome)[None, :])[0][0]


@dataclass
class BPDecoder(DecoderBase):
    """Batched flat BP for a fixed check matrix and channel prior.

    With ``early_stop=False`` on a CUDA device the decode is kernel K6
    (:func:`.bp_cuda.bp_fixed`); otherwise it is :func:`bp_core` (per-shot
    freezing with ``early_stop``, the plain version on the CPU)."""

    tables: TannerTables
    prior_llr: np.ndarray
    method: str = "ps"
    max_iter: int = 0
    ms_scaling_factor: float = 0.0
    early_stop: bool = True

    def __post_init__(self):
        self.method = normalize_method(self.method)
        if self.max_iter <= 0:  # ldpc convention: default = column count
            self.max_iter = self.tables.num_vars
        self._prior = torch.as_tensor(np.asarray(self.prior_llr, dtype=np.float32)).to(
            self.tables.device)

    @property
    def device(self) -> torch.device:
        return self.tables.device

    @classmethod
    def from_check_matrix(cls, H, *, error_rate: Optional[float] = None,
                          channel_probs: Optional[np.ndarray] = None, max_iter: int = 0,
                          bp_method: str = "ps", ms_scaling_factor: float = 0.0,
                          early_stop: bool = True, device: DeviceLike = "cuda") -> "BPDecoder":
        """Constructor with the ldpc option surface of the JAX package."""
        tanner = TannerELL.from_check_matrix(sparse.csr_matrix(H))
        prior = channel_priors(tanner.num_vars, error_rate, channel_probs)
        return cls(tanner_tables(tanner, resolve_device(device)), priors_to_llr(prior),
                   bp_method, max_iter, float(ms_scaling_factor), early_stop)

    def decode_tensors(self, syndromes: torch.Tensor):
        """(C, S) device syndromes -> (hard, posterior, conv, iters) tensors."""
        if self.early_stop:
            return bp_core(self.tables, self._prior, syndromes, self.method, self.max_iter,
                           self.ms_scaling_factor, True)
        from .bp_cuda import bp_fixed

        return bp_fixed(self.tables, self._prior, syndromes, self.method, self.max_iter,
                        self.ms_scaling_factor)


def bp_decode_batch(H, syndromes, **kw):
    """One-call decode: ``BPDecoder.from_check_matrix(H, **kw).decode_batch``."""
    return BPDecoder.from_check_matrix(H, **kw).decode_batch(syndromes)
