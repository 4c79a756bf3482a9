"""Belief-propagation building blocks shared by the port's decoders.

Counterpart of ``exp_ldpc_tpu/decoders/bp.py:53-113``: channel priors to
LLRs, the phi transform of sum-product, and the check-node update in the
check-major ``(C, D, S)`` layout (shots on the last axis).  The flat
``_bp_core`` decoder is not ported yet (ROADMAP Queue 1 item 2).

Sums over a check's slots are taken left to right in slot order, so the
port's CUDA kernels (which loop over slots) reproduce them exactly.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["BIG", "priors_to_llr", "phi", "check_update_cm", "normalize_method",
           "alpha_at", "dense_ops_bytes"]

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
