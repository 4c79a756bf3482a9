"""CPU reference BP — the statistical oracle for the JAX kernels.

Same message-passing math as :mod:`exp_ldpc_tpu.decoders.bp` (flooding
schedule, ps/ms methods, per-column priors, adaptive min-sum scaling),
written against plain numpy so the device kernels can be validated
float-for-float on identical inputs (tests/test_bp.py).  Replaces the role
of the Cython ``ldpc`` package as the host-side oracle (SURVEY.md §2.3).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .bp import priors_to_llr
from .tanner import TannerELL

__all__ = ["NumpyBPDecoder"]

_BIG = 1e30


def _phi(x):
    x = np.clip(x, 1e-7, 30.0)
    return -np.log(np.tanh(x * 0.5))


@dataclass
class NumpyBPDecoder:
    tanner: TannerELL
    prior_llr: np.ndarray
    method: str = "ps"
    max_iter: int = 0
    ms_scaling_factor: float = 0.0

    def __post_init__(self):
        self.method = {"ps": "ps", "psl": "ps", "ms": "ms", "msl": "ms"}[self.method]
        if self.max_iter <= 0:
            self.max_iter = self.tanner.num_vars

    @classmethod
    def from_check_matrix(cls, H, *, error_rate=None, channel_probs=None, max_iter=0,
                          bp_method="ps", ms_scaling_factor=0.0, **_ignored):
        tanner = TannerELL.from_check_matrix(H)
        prior = (np.asarray(channel_probs, dtype=np.float64) if channel_probs is not None
                 else np.full(tanner.num_vars, error_rate, dtype=np.float64))
        return cls(tanner, priors_to_llr(prior), bp_method, max_iter, float(ms_scaling_factor))

    def decode_batch(self, syndromes: np.ndarray):
        """(S, C) syndromes -> (hard (S,V), posterior (S,V), converged (S,), iters (S,))."""
        t = self.tanner
        synd = np.asarray(syndromes, dtype=np.uint8).T  # (C, S)
        C, S = synd.shape
        E = t.num_edges
        synd_sign = 1.0 - 2.0 * synd.astype(np.float32)

        v2c = np.zeros((E + 1, S), dtype=np.float32)
        v2c[t.chk_edges] = self.prior_llr[t.chk_vars][:, :, None]
        v2c[E] = _BIG

        hard = np.zeros((t.num_vars, S), dtype=np.uint8)
        post = np.broadcast_to(self.prior_llr[:, None], (t.num_vars, S)).copy()
        conv = np.zeros(S, dtype=bool)
        iters = np.zeros(S, dtype=np.int32)
        adaptive = self.ms_scaling_factor == 0.0

        for it in range(self.max_iter):
            if conv.all():
                break
            alpha = (1.0 - 2.0 ** -(it + 1)) if adaptive else self.ms_scaling_factor
            # check update
            m = v2c[t.chk_edges]  # (C, Dc, S)
            sign = np.where(m < 0, -1.0, 1.0).astype(np.float32)
            mag = np.abs(m)
            total_sign = sign.prod(axis=1, keepdims=True) * synd_sign[:, None, :]
            ext_sign = total_sign * sign
            if self.method == "ps":
                ph = _phi(mag)
                ext = _phi(ph.sum(axis=1, keepdims=True) - ph)
                out = ext_sign * ext
            else:
                min1 = mag.min(axis=1, keepdims=True)
                is_min = (mag == min1) & (np.cumsum(mag == min1, axis=1) == 1)
                min2 = np.where(is_min, _BIG, mag).min(axis=1, keepdims=True)
                out = ext_sign * np.where(is_min, min2, min1) * alpha
            c2v = np.zeros_like(v2c)
            c2v[t.chk_edges] = out
            c2v[E] = 0.0
            # var update
            mv = c2v[t.var_edges]
            posterior = self.prior_llr[:, None] + mv.sum(axis=1)
            v2c = np.zeros_like(v2c)
            v2c[t.var_edges] = posterior[:, None, :] - mv
            v2c[E] = _BIG
            hard_new = (posterior <= 0).astype(np.uint8)
            bits = np.where(t.chk_mask[:, :, None], hard_new[t.chk_vars], 0).astype(np.int32)
            ok = np.all(bits.sum(axis=1) % 2 == synd, axis=0)
            upd = ~conv
            hard[:, upd] = hard_new[:, upd]
            post[:, upd] = posterior[:, upd]
            iters[upd] = it + 1
            conv |= ok
        return hard.T, post.T, conv, iters

    def decode(self, syndrome):
        hard, _, _, _ = self.decode_batch(np.asarray(syndrome)[None, :])
        return hard[0]
