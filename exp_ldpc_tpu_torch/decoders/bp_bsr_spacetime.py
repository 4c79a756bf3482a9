"""Kernel K3: spacetime BP for large codes, one launch per iteration.

Counterpart of ``exp_ldpc_tpu/decoders/bp_bsr_spacetime.py``.  The TPU
kernel ``_st_kernel_iter`` streams round blocks of bf16 messages through
VMEM, one ``pallas_call`` per flooding iteration, with the loop and a
GLOBAL early exit (all shots converged) outside the kernel.  The port keeps
that contract and drops the 128x128 one-hot tile layout, which exists only
for the TPU's matrix unit: it takes the base code's ``TannerELL`` tables and
per-spacetime-column priors directly.

  * :func:`stbsr_iter` runs one iteration in place: the CUDA kernel
    ``csrc/stbsr.cu`` for CUDA tensors, its plain version
    :func:`_stbsr_iter_plain` for CPU tensors, and nothing else.
  * :func:`stbsr_decode` is the loop: fixed iterations, or a global exit
    that reads one "all converged" flag per iteration when ``early_stop``.

Numerics follow the TPU kernel (``bp_bsr_spacetime.py:195, 254-255, 263,
283-293``): messages stored in bf16, f32 accumulation, the measurement
update in closed form, the data posterior rounded to bf16 for the edge
broadcast and for its hard decision in the parity check.  Semantics match
the JAX decoder: no per-shot freezing; ``converged`` is the exact spacetime
syndrome check of the last iteration's estimate; ``iters`` is the global
iteration count.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..convert import TannerTables
from ..utils.cuda_build import CudaKernel
from .bp import BIG, alpha_at, check_update_cm, normalize_method
from .spacetime_bp import SpacetimeDecoderBase, spacetime_syndrome_ok

__all__ = ["stbsr_iter", "stbsr_decode", "SpacetimeBSRDecoder", "KERNEL"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = CudaKernel("stbsr.cu", "stbsr_iter", [_P] * 12 + [_I] * 7 + [_F, _P])

_BF16 = torch.bfloat16


def _stbsr_iter_plain(t: TannerTables, num_rounds: int, msg, mlo, mhi, synd, prior_d,
                      mprior, method: str, alpha: float, post_d, post_m, conv, c2m=None):
    """Plain version of K3, on any device (same arguments as
    :func:`stbsr_iter`; the kernel's scratch ``c2m`` is unused): one
    flooding iteration over all round blocks at once."""
    R, B = num_rounds, num_rounds + 1
    r, n, Dc, Dv = t.num_checks, t.num_vars, t.max_check_degree, t.max_var_degree
    S = msg.shape[1]
    dev = msg.device
    big_slot = torch.full((1, r, S), BIG, device=dev)
    x_d = msg.view(B, r, Dc, S).float()
    v_hi = torch.cat([big_slot, mhi.view(R, r, S).float()])   # m_{b-1} -> block b
    v_lo = torch.cat([mlo.view(R, r, S).float(), big_slot])   # m_b -> block b
    ext = torch.cat([x_d, v_hi[:, :, None], v_lo[:, :, None]], dim=2)
    synd_sign = 1.0 - 2.0 * synd.to(torch.float32)
    c2v = check_update_cm(ext.view(B * r, Dc + 2, S), synd_sign, method,
                          alpha).view(B, r, Dc + 2, S)
    c2v_d = c2v[:, :, :Dc].to(_BF16).float()                    # bf16 store (:195)
    # measurement variables: f32 messages in, bf16 messages out (:254-255)
    ext_hi, ext_lo = c2v[1:, :, Dc], c2v[:R, :, Dc + 1]
    pm = (mprior.view(R, r, 1) + ext_lo) + ext_hi
    mlo.copy_((pm - ext_lo).to(_BF16).view_as(mlo))
    mhi.copy_((pm - ext_hi).to(_BF16).view_as(mhi))
    post_m.copy_(pm.view_as(post_m))
    # data variables: prior first, then the incoming messages in edge order
    flat = torch.cat([c2v_d.reshape(B, r * Dc, S), torch.zeros((B, 1, S), device=dev)], dim=1)
    c2v_vm = flat[:, t.vm_from_cm]                              # (B, n, Dv, S)
    total = prior_d.view(B, n, 1) + c2v_vm[:, :, 0]
    for j in range(1, Dv):
        total = total + c2v_vm[:, :, j]
    post_d.copy_(total.view_as(post_d))
    pb = total.to(_BF16).float()                                # (:283)
    v2c = (pb[:, t.chk_vars] - c2v_d).to(_BF16)                 # (:292-293)
    msg.copy_(torch.where(t.chk_mask[None, :, :, None], v2c,
                          torch.tensor(BIG, dtype=_BF16, device=dev)).view_as(msg))
    ok = spacetime_syndrome_ok(pb <= 0, pm <= 0, synd.view(B, r, S), t)   # (:263, :290)
    conv.copy_(ok.to(torch.uint8))


def stbsr_iter(t: TannerTables, num_rounds: int, msg, mlo, mhi, synd, prior_d, mprior,
               method: str, alpha: float, post_d, post_m, conv, c2m=None) -> None:
    """One spacetime BP iteration, in place.

    msg ((R+1)·r·Dc, S) bf16 check-major v2c messages; mlo/mhi (R·r, S)
    bf16 measurement messages (toward the lower / upper check block);
    synd ((R+1)·r, S) uint8; prior_d ((R+1)·n,) and mprior (R·r,) f32
    LLRs.  Writes post_d ((R+1)·n, S) f32, post_m (R·r, S) f32 and conv
    (S,) uint8.  ``c2m`` (2·R·r, S) f32 is the kernel's scratch for the
    check->measurement messages.
    """
    dev = msg.device
    if dev.type == "cpu":
        _stbsr_iter_plain(t, num_rounds, msg, mlo, mhi, synd, prior_d, mprior, method,
                          alpha, post_d, post_m, conv)
        return
    if dev.type != "cuda":
        raise ValueError(f"stbsr_iter: unsupported device {dev}")
    R, B = num_rounds, num_rounds + 1
    r, n, Dc, Dv = t.num_checks, t.num_vars, t.max_check_degree, t.max_var_degree
    S = msg.shape[1]
    if Dc + 2 > 32:
        raise ValueError(f"stbsr_iter supports check degree <= 30, got {Dc}")
    shapes = {"msg": (msg, (B * r * Dc, S), _BF16), "mlo": (mlo, (R * r, S), _BF16),
              "mhi": (mhi, (R * r, S), _BF16), "synd": (synd, (B * r, S), torch.uint8),
              "prior_d": (prior_d, (B * n,), torch.float32),
              "mprior": (mprior, (R * r,), torch.float32),
              "post_d": (post_d, (B * n, S), torch.float32),
              "post_m": (post_m, (R * r, S), torch.float32), "conv": (conv, (S,), torch.uint8),
              "c2m": (c2m, (2 * R * r, S), torch.float32)}
    for name, (x, shape, dtype) in shapes.items():
        if x is None or tuple(x.shape) != shape or x.dtype != dtype or x.device != dev \
                or not x.is_contiguous():
            raise ValueError(f"stbsr_iter: {name} must be a contiguous {dtype} tensor of "
                             f"shape {shape} on {dev}")
    if t.device != dev:
        raise ValueError("stbsr_iter: tables and messages must share one device")
    KERNEL.launch(
        t.chk_vars_k.data_ptr(), t.vm_k.data_ptr(), msg.data_ptr(), mlo.data_ptr(),
        mhi.data_ptr(), synd.data_ptr(), prior_d.data_ptr(), mprior.data_ptr(),
        post_d.data_ptr(), post_m.data_ptr(), conv.data_ptr(), c2m.data_ptr(),
        r, n, Dc, Dv, R, S, 0 if method == "ps" else 1, float(alpha),
        torch.cuda.current_stream(dev).cuda_stream)


def stbsr_decode(tables: TannerTables, num_rounds: int, prior_llr: torch.Tensor,
                 syndromes: torch.Tensor, method: str, max_iter: int,
                 ms_scaling_factor: float, early_stop: bool = True, *,
                 iterate=stbsr_iter):
    """syndromes ((R+1)·r, S) 0/1 on the decode device -> (hard (Vst, S)
    uint8, posterior (Vst, S) f32, converged (S,) bool, iters (S,) int32)
    in ``SpacetimeCode`` column order.  Global early exit when
    ``early_stop``: the loop stops once every shot has converged.
    ``iterate`` is the per-iteration step; passing ``_stbsr_iter_plain``
    runs the plain version on the tensors' device (kernel comparisons)."""
    method = normalize_method(method)
    t = tables
    R, B = int(num_rounds), int(num_rounds) + 1
    if R < 1:
        raise ValueError("stbsr_decode needs num_rounds >= 1")
    r, n, Dc = t.num_checks, t.num_vars, t.max_check_degree
    Cs, S = syndromes.shape
    if Cs != B * r:
        raise ValueError(f"syndromes have {Cs} rows, expected {B * r}")
    dev = syndromes.device
    prior = prior_llr.to(device=dev, dtype=torch.float32)
    prior_d = prior[: B * n].contiguous()
    mprior = prior[B * n:].contiguous()
    edge_prior = torch.where(t.chk_mask[None], prior_d.view(B, n)[:, t.chk_vars], BIG)
    msg = edge_prior.reshape(B * r * Dc, 1).to(_BF16).expand(B * r * Dc, S).contiguous()
    mlo = mprior[:, None].to(_BF16).expand(R * r, S).contiguous()
    mhi = mlo.clone()
    synd = syndromes.to(torch.uint8).contiguous()
    post_d = torch.zeros((B * n, S), dtype=torch.float32, device=dev)
    post_m = torch.zeros((R * r, S), dtype=torch.float32, device=dev)
    conv = torch.zeros((S,), dtype=torch.uint8, device=dev)
    c2m = torch.empty((2 * R * r, S), dtype=torch.float32, device=dev) \
        if dev.type == "cuda" else None
    it = 0
    while it < max_iter:
        iterate(t, R, msg, mlo, mhi, synd, prior_d, mprior, method,
                alpha_at(it, ms_scaling_factor), post_d, post_m, conv, c2m)
        it += 1
        if early_stop and bool(conv.all()):
            break
    posterior = torch.cat([post_d, post_m])
    hard = (posterior <= 0).to(torch.uint8)
    return hard, posterior, conv.bool(), torch.full((S,), it, dtype=torch.int32, device=dev)


@dataclass
class SpacetimeBSRDecoder(SpacetimeDecoderBase):
    """Batched multi-round spacetime BP on kernel K3 (global early exit).

    Same interface as :class:`.spacetime_bp.SpacetimeBPDecoder`, so it
    drops into :class:`.bposd.BPOSDDecoder` as the BP stage."""

    method: str = "ms"

    def __post_init__(self):
        if self.num_rounds < 1:
            raise ValueError("SpacetimeBSRDecoder needs num_rounds >= 1")
        super().__post_init__()

    def decode_tensors(self, syndromes: torch.Tensor):
        return stbsr_decode(self.tables, self.num_rounds, self._prior, syndromes,
                            self.method, self.max_iter, self.ms_scaling_factor,
                            self.early_stop)
