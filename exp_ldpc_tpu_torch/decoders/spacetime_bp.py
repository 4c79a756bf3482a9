"""Structured spacetime BP in plain PyTorch.

Counterpart of ``exp_ldpc_tpu/decoders/spacetime_bp.py``: flooding BP on
the spacetime matrix of ``SpacetimeCode`` ((rounds+1) copies of the base H
on the diagonal plus degree-2 measurement-error columns linking consecutive
rounds), run in factored form:

  * data-column messages live in a (B, r, Dc, S) tensor (B = rounds+1
    round blocks) and route through the BASE code's Tanner tables, batched
    over the round axis;
  * each check gets two extra slots for its measurement-error variables
    (previous/next round); the check update is :func:`.bp.check_update_cm`
    on (B·r, Dc+2, S);
  * measurement variables have degree 2 and update in closed form.

:func:`stbp_core` is the plain version of the CUDA kernel K2
(:mod:`.spacetime_bp_cuda`), which computes its fixed-iteration mode.
Column/row conventions match ``SpacetimeCode``: rows are round-major blocks
of r checks; columns are B·n data bits (round-major) then R·r measurement
bits.  Messages are float32, or with ``msg_dtype="bfloat16"`` stored in
bf16 and rounded where the JAX core rounds them
(``exp_ldpc_tpu/decoders/spacetime_bp.py::_stbp_core``): every operation of
the check update rounds to bf16 (XLA computes a bf16 op in f32 and rounds
its result), the variable sums accumulate in f32, the data posterior is
rounded to bf16 before the edge broadcast and each outgoing message after
it.  The JAX core has two formulations of the variable update, a one-hot
matrix product and a gather; they lay out the same sums, and the port has
one layout, the gather of the Tanner tables, with the matrix product's
rounding points (the one JAX's ``"auto"`` takes wherever the dense
operands fit, and K3's: the posterior rounded before the broadcast).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from scipy import sparse

from ..convert import TannerTables, prior_llr_st, tanner_tables
from ..utils.device import DeviceLike, resolve_device
from .bp import (_PHI_CLAMP_HI, _PHI_CLAMP_LO, BIG, DecoderBase, _slot_sum, alpha_at,
                 channel_priors, check_parity, check_update_cm, normalize_method, priors_to_llr)
from .tanner import TannerELL

__all__ = ["stbp_core", "SpacetimeBPDecoder", "SpacetimeDecoderBase", "MSG_DTYPES"]

MSG_DTYPES = ("float32", "bfloat16")


def _bf(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to the nearest bf16 value (ties to even), kept as f32."""
    return x.to(torch.bfloat16).float()


_BF_LO = float(_bf(torch.tensor(_PHI_CLAMP_LO)))   # the JAX clamp constant in bf16


def _phi_bf(x: torch.Tensor) -> torch.Tensor:
    """phi on bf16 values, every operation rounded to bf16 as XLA rounds a
    bf16 computation (the clamp bounds are bf16 constants)."""
    x = x.clamp(_BF_LO, _PHI_CLAMP_HI)
    return -_bf(torch.log(_bf(torch.tanh(_bf(x * 0.5)))))


def check_update_bf16(v2c_cm: torch.Tensor, synd_sign: torch.Tensor, method: str,
                      alpha: float) -> torch.Tensor:
    """:func:`.bp.check_update_cm` on bf16 messages (held in f32), rounded
    as the JAX check update on a bf16 array rounds: each elementwise result
    to bf16, the phi total summed in f32 (left to right) and then rounded;
    ``alpha`` is rounded to bf16 first.  Returns bf16 values in f32."""
    sign = torch.where(v2c_cm < 0, -1.0, 1.0)
    mag = v2c_cm.abs()
    ext_sign = torch.prod(sign, dim=1, keepdim=True) * synd_sign[:, None, :] * sign
    if method == "ps":
        ph = _phi_bf(mag)
        total = _bf(_slot_sum(ph))[:, None, :]
        return ext_sign * _phi_bf(_bf(total - ph))
    min1 = mag.min(dim=1, keepdim=True).values
    hit = mag == min1
    is_min = hit & (torch.cumsum(hit.to(torch.int32), dim=1) == 1)
    min2 = torch.where(is_min, BIG, mag).min(dim=1, keepdim=True).values
    return _bf(ext_sign * torch.where(is_min, min2, min1) * float(_bf(torch.tensor(alpha))))


def spacetime_syndrome_ok(hard_d, hard_m, synd, t: TannerTables) -> torch.Tensor:
    """(S,) bool: the spacetime parity of (hard_d (B,n,S), hard_m (R,r,S))
    equals ``synd`` (B, r, S)."""
    zeros = torch.zeros_like(synd[:1], dtype=torch.int32)
    hm = hard_m.to(torch.int32)
    par = (check_parity(hard_d, t)
           + torch.cat([zeros, hm]) + torch.cat([hm, zeros])) % 2
    return (par == synd.to(torch.int32)).all(dim=1).all(dim=0)


def stbp_core(tables: TannerTables, num_rounds: int, prior_llr: torch.Tensor,
              syndromes: torch.Tensor, method: str, max_iter: int,
              ms_scaling_factor: float, early_stop: bool = True,
              msg_dtype: str = "float32"):
    """Structured spacetime BP on the tensors' device.

    prior_llr: (B·n + R·r,) f32 per-column LLRs; syndromes: (B·r, S) 0/1.
    Returns (hard (Vst, S) uint8, posterior (Vst, S) f32, converged (S,)
    bool, iters (S,) int32).  ``early_stop`` freezes each shot at its first
    convergence (ldpc semantics); without it every shot runs ``max_iter``
    flooding iterations and ``converged`` is the final syndrome check.
    ``msg_dtype="bfloat16"`` stores the messages in bf16 (the module
    docstring says where it rounds); posteriors stay f32.
    """
    method = normalize_method(method)
    if msg_dtype not in MSG_DTYPES:
        raise ValueError(f"msg_dtype must be one of {MSG_DTYPES}, got {msg_dtype!r}")
    bf16 = msg_dtype == "bfloat16"
    rnd = _bf if bf16 else (lambda x: x)
    t = tables
    R, B = int(num_rounds), int(num_rounds) + 1
    r, n, Dc, Dv = t.num_checks, t.num_vars, t.max_check_degree, t.max_var_degree
    S = syndromes.shape[1]
    dev = syndromes.device
    prior = prior_llr.to(device=dev, dtype=torch.float32)
    data_llr = prior[: B * n].reshape(B, n)
    meas_llr = prior[B * n:].reshape(R, r)
    synd = syndromes.reshape(B, r, S)
    synd_sign = (1.0 - 2.0 * synd.to(torch.float32)).reshape(B * r, S)

    edge_prior = torch.where(t.chk_mask[None], data_llr[:, t.chk_vars], BIG)  # (B, r, Dc)
    v2c_data = rnd(edge_prior[..., None].expand(B, r, Dc, S).contiguous())
    v2c_mlo = rnd(meas_llr[..., None].expand(R, r, S).contiguous())
    v2c_mhi = v2c_mlo.clone()
    big_slot = rnd(torch.full((1, r, S), BIG, device=dev))
    zero_row = torch.zeros((B, 1, S), device=dev)
    big_row = rnd(torch.full((B, 1, S), BIG, device=dev))
    update = check_update_bf16 if bf16 else check_update_cm

    def step(it, v2c_data, v2c_mlo, v2c_mhi):
        slot_prev = torch.cat([big_slot, v2c_mhi])   # m_{b-1} -> check block b
        slot_next = torch.cat([v2c_mlo, big_slot])   # m_b -> check block b
        v2c_ext = torch.cat([v2c_data, slot_prev[:, :, None], slot_next[:, :, None]], dim=2)
        c2v_ext = update(v2c_ext.reshape(B * r, Dc + 2, S), synd_sign, method,
                         alpha_at(it, ms_scaling_factor)).reshape(B, r, Dc + 2, S)
        c2v_data = c2v_ext[:, :, :Dc]
        # data-variable update: base-code gather, summed in edge order
        flat = torch.cat([c2v_data.reshape(B, r * Dc, S), zero_row], dim=1)
        c2v_vm = flat[:, t.vm_from_cm]                       # (B, n, Dv, S)
        totals = c2v_vm[:, :, 0]
        for j in range(1, Dv):
            totals = totals + c2v_vm[:, :, j]
        posterior_d = data_llr[:, :, None] + totals          # (B, n, S)
        # bf16: the posterior is rounded before the broadcast, each message after it
        v2c_vm = rnd(rnd(posterior_d)[:, :, None] - c2v_vm)
        flat_vm = torch.cat([v2c_vm.reshape(B, n * Dv, S), big_row], dim=1)
        v2c_data = flat_vm[:, t.cm_from_vm]                   # (B, r, Dc, S)
        # measurement-variable update (degree 2, closed form)
        c2m_lo = c2v_ext[:R, :, Dc + 1]
        c2m_hi = c2v_ext[1:, :, Dc]
        posterior_m = meas_llr[:, :, None] + c2m_lo + c2m_hi  # (R, r, S)
        return ((v2c_data, rnd(posterior_m - c2m_lo), rnd(posterior_m - c2m_hi)), posterior_d,
                posterior_m)

    def flatten(pd, pm):
        post = torch.cat([pd.reshape(B * n, S), pm.reshape(R * r, S)])
        return (post <= 0).to(torch.uint8), post

    if not early_stop:
        pd = data_llr[:, :, None].expand(B, n, S)
        pm = meas_llr[:, :, None].expand(R, r, S)
        msgs = (v2c_data, v2c_mlo, v2c_mhi)
        for it in range(max_iter):
            msgs, pd, pm = step(it, *msgs)
        hard, post = flatten(pd, pm)
        conv = spacetime_syndrome_ok(pd <= 0, pm <= 0, synd, t)
        return hard, post, conv, torch.full((S,), max_iter, dtype=torch.int32, device=dev)

    post = prior[:, None].expand(B * n + R * r, S).clone()
    hard = (post <= 0).to(torch.uint8)
    conv = torch.zeros(S, dtype=torch.bool, device=dev)
    iters = torch.zeros(S, dtype=torch.int32, device=dev)
    msgs = (v2c_data, v2c_mlo, v2c_mhi)
    it = 0
    while it < max_iter and not bool(conv.all()):
        msgs, pd, pm = step(it, *msgs)
        hard_new, post_new = flatten(pd, pm)
        ok = spacetime_syndrome_ok(pd <= 0, pm <= 0, synd, t)
        # freeze each shot's outputs at its first convergence
        hard = torch.where(conv[None], hard, hard_new)
        post = torch.where(conv[None], post, post_new)
        iters = torch.where(conv, iters, it + 1)
        conv = conv | ok
        it += 1
    return hard, post, conv, iters


@dataclass
class SpacetimeDecoderBase(DecoderBase):
    """State and construction shared by the spacetime decoders
    (:class:`SpacetimeBPDecoder` and
    :class:`.bp_bsr_spacetime.SpacetimeBSRDecoder`); a subclass supplies
    :meth:`decode_tensors` on (B·r, S) syndromes in ``SpacetimeCode`` row
    order, and ``decode_batch`` returns numpy (hard (S, Vst), posterior
    (S, Vst), converged (S,), iters (S,)).
    """

    tables: TannerTables
    num_rounds: int
    prior_llr: np.ndarray   # (B*n + R*r,)
    max_iter: int
    method: str = "ps"
    ms_scaling_factor: float = 0.0
    early_stop: bool = True

    def __post_init__(self):
        self.method = normalize_method(self.method)
        self._prior = prior_llr_st(self.prior_llr, self.tables.device)

    @property
    def device(self) -> torch.device:
        return self.tables.device

    @classmethod
    def from_check_matrix(cls, H, num_rounds: int, *, error_rate: Optional[float] = None,
                          channel_probs: Optional[np.ndarray] = None, max_iter: int = 0,
                          bp_method: Optional[str] = None, ms_scaling_factor: float = 0.0,
                          early_stop: bool = True, device: DeviceLike = "cuda", **options):
        """H is the BASE check matrix (r, n); priors are per spacetime
        column ((rounds+1)·n data + rounds·r measurement), or a scalar.
        ``bp_method`` defaults to the class's ``method``; ``options`` are the
        subclass's own fields (``msg_dtype``)."""
        H = sparse.csr_matrix(H)
        r, n = H.shape
        R = int(num_rounds)
        n_st = (R + 1) * n + R * r
        priors = channel_priors(n_st, error_rate, channel_probs)
        tables = tanner_tables(TannerELL.from_check_matrix(H), resolve_device(device))
        if max_iter <= 0:  # ldpc convention: default = column count
            max_iter = n_st
        return cls(tables, R, priors_to_llr(priors), max_iter,
                   cls.method if bp_method is None else bp_method,
                   float(ms_scaling_factor), early_stop, **options)


@dataclass
class SpacetimeBPDecoder(SpacetimeDecoderBase):
    """Batched structured spacetime BP on one device.  With
    ``early_stop=False`` on a CUDA device the decode is fixed-iteration
    flooding on kernel K2 (:func:`.spacetime_bp_cuda.stbp_fixed`); otherwise
    (per-shot freezing, or the CPU) it is :func:`stbp_core`.

    ``msg_dtype`` ("float32" or "bfloat16") is the message type of
    :func:`stbp_core`.  As in the JAX package, whose Pallas kernel ignores
    the option, the kernel takes precedence on the card: K2 keeps its f32
    messages (and K3, :class:`.bp_bsr_spacetime.SpacetimeBSRDecoder`, its
    bf16 ones) whatever ``msg_dtype`` says.
    """

    msg_dtype: str = "float32"

    def __post_init__(self):
        if self.msg_dtype not in MSG_DTYPES:
            raise ValueError(f"msg_dtype must be one of {MSG_DTYPES}, got {self.msg_dtype!r}")
        super().__post_init__()

    def decode_tensors(self, syndromes: torch.Tensor):
        if self.early_stop or syndromes.device.type == "cpu":
            return stbp_core(self.tables, self.num_rounds, self._prior, syndromes,
                             self.method, self.max_iter, self.ms_scaling_factor,
                             self.early_stop, self.msg_dtype)
        from .spacetime_bp_cuda import stbp_fixed

        return stbp_fixed(self.tables, self.num_rounds, self._prior, syndromes,
                          self.method, self.max_iter, self.ms_scaling_factor)
