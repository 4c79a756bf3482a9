"""Kernel K3: spacetime BP for large codes, the iteration loop on the device.

Counterpart of ``exp_ldpc_tpu/decoders/bp_bsr_spacetime.py``.  The TPU
kernel ``_st_kernel_iter`` streams round blocks of bf16 messages through
VMEM, one ``pallas_call`` per flooding iteration, with the loop and a
GLOBAL early exit (all shots converged) outside the kernel.  The port keeps
that contract and drops the 128x128 one-hot tile layout, which exists only
for the TPU's matrix unit: it takes the base code's ``TannerELL`` tables and
per-spacetime-column priors directly.

  * :func:`stbsr_iter` runs one iteration in place: the CUDA kernels of
    ``csrc/stbsr.cu`` for CUDA tensors, its plain version
    :func:`_stbsr_iter_plain` for CPU tensors, and nothing else.
  * :func:`stbsr_decode` is the loop.  On a CUDA device one call of the C
    entry point enqueues every iteration (three grids each: checks,
    variables, parity) and the host reads nothing back: with ``early_stop``
    the kernels test a ``done`` word in device memory, set by the parity
    phase of the first iteration after which every shot satisfies its
    syndrome, and count the iterations that ran.  On the CPU (or with
    ``iterate`` given) it is a Python loop over single iterations that
    tests ``conv.all()``.

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
from typing import NamedTuple

import torch

from ..convert import TannerTables
from ..utils.cuda_build import (MAX_SLOTS, WIDE_VECS, CudaKernel, RowShotPlan, aligned,
                                row_shot_plan)
from .bp import BIG, alpha_at, check_update_cm, normalize_method
from .spacetime_bp import SpacetimeDecoderBase, spacetime_syndrome_ok

__all__ = ["stbsr_iter", "stbsr_decode", "SpacetimeBSRDecoder", "KERNEL"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# csrc/stbsr.cu::stbsr_run: 14 arrays; r, n, Dc, Dv, R, S, S_live, method; alpha; adaptive,
# it0, n_iter, (vec, blocks, wide) of the check phase, (vec, blocks) of the other two; the
# stream.  One call = n_iter iterations = 3 * n_iter grids: ``KERNEL.launches`` counts
# calls, ``KERNEL.routes`` splits them by the check phase's route.
KERNEL = CudaKernel("stbsr.cu", "stbsr_run", [_P] * 14 + [_I] * 8 + [_F] + [_I] * 10 + [_P])

_BF16 = torch.bfloat16
# The device-side loop pads its shot axis to this multiple (all-zero
# syndromes, which never count towards the exit), so that every row of every
# array starts on a 16-byte boundary and the kernels take their vector paths.
_SHOT_ALIGN = 16


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


class _Plans(NamedTuple):
    """Lane width and grid of K3's three phases (``csrc/stbsr.cu``)."""

    checks: RowShotPlan
    variables: RowShotPlan
    parity: RowShotPlan


def launch_plans(t: TannerTables, num_rounds: int, shots: int, sm_count: int,
                 vectors: bool = True) -> _Plans:
    """Phase A walks the (R+1)·r checks, phase B the R·r measurement and
    (R+1)·n data variables, phase C the (R+1)·r parities, each times the
    shot vectors.  Phase A keeps a check's Dc + 2 messages of every owned
    shot in registers, so it takes 4 shots a lane up to 16 slots and 2
    above; past ``MAX_SLOTS`` slots it takes route "wide" (the two-pass
    scan, a few running values per shot: up to 8 shots a lane); phase B
    takes up to 8 (16 bytes of bf16, two accesses of f32), the parity phase
    moves bytes and takes up to 16.  ``vectors`` is false when an array
    does not start on a 16-byte boundary."""
    R, B = num_rounds, num_rounds + 1
    r, n, P = t.num_checks, t.num_vars, t.max_check_degree + 2
    wide = P > MAX_SLOTS
    va = WIDE_VECS if wide else (4,) if P <= 16 else (2,)
    vb, vc = (8, 4, 2), (16, 8, 4)
    if not vectors:
        va, vb, vc = (), (), ()
    return _Plans(row_shot_plan(B * r, shots, va, sm_count)._replace(
                      route="wide" if wide else "default"),
                  row_shot_plan(R * r + B * n, shots, vb, sm_count),
                  row_shot_plan(B * r, shots, vc, sm_count))


def _run(t: TannerTables, R: int, msg, mlo, mhi, synd, prior_d, mprior, post_d, post_m, conv,
         c2m, hard, flags, live: int, method: str, alpha: float, adaptive: bool, n_iter: int):
    """``n_iter`` iterations on the card, in place (one call of the entry point)."""
    dev = msg.device
    S = msg.shape[1]
    state = (msg, mlo, mhi, synd, post_d, post_m, conv, c2m, hard)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    pa, pb, pc = launch_plans(t, R, S, sms, aligned(*state))
    KERNEL.launch(
        t.chk_vars_k.data_ptr(), t.vm_k.data_ptr(), msg.data_ptr(), mlo.data_ptr(),
        mhi.data_ptr(), synd.data_ptr(), prior_d.data_ptr(), mprior.data_ptr(),
        post_d.data_ptr(), post_m.data_ptr(), conv.data_ptr(), c2m.data_ptr(), hard.data_ptr(),
        None if flags is None else flags.data_ptr(),
        t.num_checks, t.num_vars, t.max_check_degree, t.max_var_degree, R, S, live,
        0 if method == "ps" else 1, float(alpha), int(adaptive), 0, n_iter,
        pa.vec, pa.blocks, int(pa.route == "wide"), pb.vec, pb.blocks, pc.vec, pc.blocks,
        torch.cuda.current_stream(dev).cuda_stream, route=pa.route)


def stbsr_iter(t: TannerTables, num_rounds: int, msg, mlo, mhi, synd, prior_d, mprior,
               method: str, alpha: float, post_d, post_m, conv, c2m=None) -> None:
    """One spacetime BP iteration, in place.

    msg ((R+1)·r·Dc, S) bf16 check-major v2c messages; mlo/mhi (R·r, S)
    bf16 measurement messages (toward the lower / upper check block);
    synd ((R+1)·r, S) uint8; prior_d ((R+1)·n,) and mprior (R·r,) f32
    LLRs.  Writes post_d ((R+1)·n, S) f32, post_m (R·r, S) f32 and conv
    (S,) uint8.  ``c2m`` (2·R·r, S) f32 is the kernels' scratch for the
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
    r, n, Dc = t.num_checks, t.num_vars, t.max_check_degree
    S = msg.shape[1]
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
    if S == 0:
        return
    hard = torch.empty((B * n + R * r, S), dtype=torch.uint8, device=dev)
    _run(t, R, msg, mlo, mhi, synd, prior_d, mprior, post_d, post_m, conv, c2m, hard, None,
         S, method, alpha, False, 1)


def stbsr_decode(tables: TannerTables, num_rounds: int, prior_llr: torch.Tensor,
                 syndromes: torch.Tensor, method: str, max_iter: int,
                 ms_scaling_factor: float, early_stop: bool = True, *, iterate=None):
    """syndromes ((R+1)·r, S) 0/1 on the decode device -> (hard (Vst, S)
    uint8, posterior (Vst, S) f32, converged (S,) bool, iters (S,) int32)
    in ``SpacetimeCode`` column order.  Global early exit when
    ``early_stop``: the loop stops once every shot has converged.
    ``iterate`` is a per-iteration step to loop over on the host instead,
    at the caller's shot count (``_stbsr_iter_plain`` runs the plain version
    on the tensors' device, ``stbsr_iter`` single iterations of the kernels,
    for comparisons); by default CUDA tensors run the device-side loop and
    CPU tensors the plain iteration."""
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
    on_card = dev.type == "cuda"
    device_loop = iterate is None and on_card
    Sp = -(-S // _SHOT_ALIGN) * _SHOT_ALIGN if device_loop else S
    prior = prior_llr.to(device=dev, dtype=torch.float32)
    prior_d = prior[: B * n].contiguous()
    mprior = prior[B * n:].contiguous()
    edge_prior = torch.where(t.chk_mask[None], prior_d.view(B, n)[:, t.chk_vars], BIG)
    msg = edge_prior.reshape(B * r * Dc, 1).to(_BF16).expand(B * r * Dc, Sp).contiguous()
    mlo = mprior[:, None].to(_BF16).expand(R * r, Sp).contiguous()
    mhi = mlo.clone()
    if Sp == S:
        synd = syndromes.to(torch.uint8).contiguous()
    else:
        synd = torch.zeros((B * r, Sp), dtype=torch.uint8, device=dev)
        synd[:, :S] = syndromes
    post_d = torch.zeros((B * n, Sp), dtype=torch.float32, device=dev)
    post_m = torch.zeros((R * r, Sp), dtype=torch.float32, device=dev)
    conv = torch.zeros((Sp,), dtype=torch.uint8, device=dev)
    c2m = torch.empty((2 * R * r, Sp), dtype=torch.float32, device=dev) if on_card else None
    if device_loop:
        if t.device != dev:
            raise ValueError("stbsr_decode: tables and syndromes must share one device")
        hard = torch.empty((B * n + R * r, Sp), dtype=torch.uint8, device=dev)
        flags = torch.zeros(4, dtype=torch.int32, device=dev) if early_stop else None
        if S > 0 and max_iter > 0:
            msf = float(ms_scaling_factor)
            _run(t, R, msg, mlo, mhi, synd, prior_d, mprior, post_d, post_m, conv, c2m, hard,
                 flags, S, method, alpha_at(0, msf), msf == 0.0, int(max_iter))
        iters = flags[1].expand(S).contiguous() if early_stop \
            else torch.full((S,), max(int(max_iter), 0), dtype=torch.int32, device=dev)
    else:
        iterate = stbsr_iter if iterate is None else iterate
        it = 0
        while it < max_iter:
            iterate(t, R, msg, mlo, mhi, synd, prior_d, mprior, method,
                    alpha_at(it, ms_scaling_factor), post_d, post_m, conv, c2m)
            it += 1
            if early_stop and bool(conv.all()):
                break
        iters = torch.full((S,), it, dtype=torch.int32, device=dev)
    posterior = torch.cat([post_d[:, :S], post_m[:, :S]])
    hard = (posterior <= 0).to(torch.uint8)
    return hard, posterior, conv[:S].bool(), iters


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
