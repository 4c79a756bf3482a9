"""Kernel K10: the relay BP ensemble, a whole decode in one launch.

The CUDA source is ``csrc/relay.cu``; its header says how the design meets
the ensemble's uneven work (leg 0 on every shot, the later legs on the few
shots leg 0 leaves unsolved).  The plain version is
:func:`.relay_bp.relay_core`: hard decisions, posteriors, ``converged`` and
the solving leg are bit-identical to it.

:func:`takes` is the route rule, a pure function of what the caller sees
before the launch: min-sum with at least one leg, where one shot's messages
and lam fit one block's shared memory (the gross code over 12 rounds, 936 x
2,736; HGP-225 over 4 rounds, 540 x 1,557; HGP-225's 1-round circuit-noise
detector model, 216 x 1,518, on route "wide").  Elsewhere (sum-product, or a
shot past a block, such as ``validate_dem``'s 864 x 36,491 detector model)
:meth:`.relay_bp.RelayBPDecoder.decode_tensors` runs the plain version.
``KERNEL.launches`` counts decodes, ``KERNEL.routes`` splits them by
:attr:`RelayPlan.label`: "default", or "wide" past ``MAX_SLOTS`` slots.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from ..convert import TannerTables
from ..utils.cuda_build import (MAX_SLOTS, CudaKernel, device_limits, resident_fit,
                                resident_max_threads)

__all__ = ["KERNEL", "RelayPlan", "relay_bytes", "launch_plan", "takes", "relay_decode"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# csrc/relay.cu::relay_decode: 9 arrays; C, V, Dc, Dv, S, L, iters; alpha0; group, threads,
# tables_smem, smem_bytes, blocks, wide; the stream
KERNEL = CudaKernel("relay.cu", "relay_decode", [_P] * 9 + [_I] * 7 + [_F] + [_I] * 6 + [_P])


class RelayPlan(NamedTuple):
    """Launch of one K10 decode: ``blocks`` persistent blocks (at most one
    an SM) of ``group`` shot slots that take the batch's shots from a queue,
    ``threads`` a block, ``smem_bytes`` of dynamic shared memory (the tables
    there too when ``tables_smem``).  ``wide``: checks of more than
    ``MAX_SLOTS`` slots (route "wide")."""

    group: int
    blocks: int
    threads: int
    tables_smem: bool
    smem_bytes: int
    wide: bool = False

    @property
    def label(self) -> str:
        """The route as ``KERNEL.routes`` counts it: "default" or "wide"."""
        return "wide" if self.wide else "default"


def relay_bytes(tables: TannerTables) -> Tuple[int, int, int]:
    """(bytes per shot slot, fixed bytes, table bytes) of a block's shared
    memory (``csrc/relay.cu::relay_bytes``): per slot every f32 message, its
    lam, five int32 words of slot state and its syndrome bytes; fixed, four
    control words and each check's live-slot mask; the two Tanner tables
    (int32)."""
    C, V, Dc, Dv = (tables.num_checks, tables.num_vars, tables.max_check_degree,
                    tables.max_var_degree)
    return 4 * (Dc * C + V + 5) + C, 4 * (4 + C), 4 * (C * Dc + V * Dv)


def launch_plan(tables: TannerTables, shots: int, device: torch.device, *,
                max_group: Optional[int] = None,
                tables_smem: Optional[bool] = None) -> Optional[RelayPlan]:
    """The launch of one decode of ``shots`` shots on ``device``, or None
    where one shot does not fit a block: a block an SM (two an SM, or the
    tables through the read-only cache, ran slower at the gross code x 12;
    PERF.md, K10), each with as many slots as fit the card's opt-in shared
    memory (at most ``max_group``), the tables there too where they fit
    beside one shot (``tables_smem`` True or False forces the choice); a
    batch of fewer shots than one wave's slots spreads evenly over the SMs.
    The tests force a plan to reach each path of the kernel at small
    shapes."""
    if shots < 1:
        raise ValueError(f"shots must be positive, got {shots}")
    smem, sms = device_limits(KERNEL, device)
    per_slot, fixed, table = relay_bytes(tables)
    if per_slot + fixed > smem:
        return None
    in_smem, most = resident_fit(per_slot, table, smem, fixed)
    if tables_smem is not None and bool(tables_smem) != in_smem:
        in_smem = bool(tables_smem)
        most = (smem - fixed - (table if in_smem else 0)) // per_slot
        if most < 1:
            return None
    if max_group is not None:
        most = max(1, min(most, int(max_group)))
    group = most if shots > sms * most else -(-shots // sms)
    Dc = tables.max_check_degree
    return RelayPlan(group, min(-(-shots // group), sms), resident_max_threads(Dc), in_smem,
                     group * per_slot + fixed + (table if in_smem else 0), Dc > MAX_SLOTS)


def takes(tables: TannerTables, method: str, num_legs: int, device: torch.device) -> bool:
    """Whether K10 runs a decode over ``tables`` on ``device``: a CUDA
    device, min-sum, at least one leg, and one shot that fits a block."""
    if device.type != "cuda" or method != "ms" or num_legs < 1:
        return False
    smem, _sms = device_limits(KERNEL, device)
    per_slot, fixed, _table = relay_bytes(tables)
    return per_slot + fixed <= smem


def relay_decode(tables: TannerTables, prior_llr: torch.Tensor, syndromes: torch.Tensor,
                 gammas: torch.Tensor, num_legs: int, iters_per_leg: int,
                 ms_scaling_factor: float, plan: Optional[RelayPlan] = None):
    """:func:`.relay_bp.relay_core`'s outputs for min-sum on CUDA tensors:
    prior_llr (V,) f32, syndromes (C, S) 0/1, gammas (num_legs, V) f32 ->
    (hard (V, S) uint8, posterior (V, S) f32, converged (S,) bool,
    solved_leg (S,) int32).  ``plan`` overrides :func:`launch_plan` (the
    benchmarks' sweeps)."""
    dev = syndromes.device
    if dev.type != "cuda":
        raise ValueError(f"relay_decode: unsupported device {dev}")
    t = tables
    C, V, Dc, Dv = t.num_checks, t.num_vars, t.max_check_degree, t.max_var_degree
    Cs, S = syndromes.shape
    if Cs != C:
        raise ValueError(f"syndromes have {Cs} rows, expected {C}")
    if num_legs < 1 or iters_per_leg < 0:
        raise ValueError(f"relay_decode needs num_legs >= 1 and iters_per_leg >= 0, got "
                         f"{num_legs} and {iters_per_leg}")
    if t.device != dev or prior_llr.device != dev or gammas.device != dev:
        raise ValueError("relay_decode: tables, priors, gammas and syndromes must share one "
                         "device")
    prior = prior_llr.to(torch.float32).contiguous()
    gam = gammas.to(torch.float32).contiguous()
    if prior.shape != (V,) or gam.shape != (num_legs, V):
        raise ValueError(f"prior_llr must have shape ({V},) and gammas ({num_legs}, {V})")
    post = torch.empty((V, S), dtype=torch.float32, device=dev)
    conv = torch.empty((S,), dtype=torch.uint8, device=dev)
    solved = torch.empty((S,), dtype=torch.int32, device=dev)
    if S == 0:  # a grid of no blocks is not a launch
        return post.to(torch.uint8), post, conv.bool(), solved
    plan = plan or launch_plan(t, S, dev)
    if plan is None:
        raise ValueError(f"K10: one shot ({sum(relay_bytes(t)[:2])} B) does not fit a block")
    synd = syndromes.to(torch.uint8).contiguous()
    head = torch.empty((1,), dtype=torch.int32, device=dev)   # the queue, zeroed by the call
    KERNEL.launch(
        synd.data_ptr(), prior.data_ptr(), gam.data_ptr(), t.chk_vars_k.data_ptr(),
        t.vm_k.data_ptr(), post.data_ptr(), conv.data_ptr(), solved.data_ptr(), head.data_ptr(),
        C, V, Dc, Dv, S, int(num_legs), int(iters_per_leg), float(ms_scaling_factor),
        plan.group, plan.threads, int(plan.tables_smem), plan.smem_bytes, plan.blocks,
        int(plan.wide), torch.cuda.current_stream(dev).cuda_stream, route=plan.label)
    return (post <= 0).to(torch.uint8), post, conv.bool(), solved
