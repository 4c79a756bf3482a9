"""Kernels K1 and K5: flat BP for large codes, bf16 and int8 messages.

Counterpart of ``exp_ldpc_tpu/decoders/bp_bsr.py``.  The TPU kernel
``_kernel`` keeps one shot block's bf16 messages in VMEM for the whole
decode and routes them through 128x128 one-hot tiles on the matrix unit;
``_kernel_dyn`` (K1b) is the same math with rolled loops for schedules of
>= 3,000 tiles.  The port keeps the contract and drops the tile layout,
which exists only for the TPU's matrix unit: it routes through the
``TannerELL`` tables, with rolled loops at every size, so one kernel
serves both K1 and K1b.

  * :func:`bsr_bp_decode` is the decode: the CUDA kernels of
    ``csrc/bsr_bp.cu`` for CUDA tensors, its plain version
    :func:`bsr_bp_plain` for CPU tensors, and nothing else.
  * :func:`bsr_bp_decode_int8` is the fixed-point min-sum decode (the TPU
    kernel ``_kernel_int8``, K5): the CUDA kernels of ``csrc/bsr_bp_int8.cu``
    for CUDA tensors, its plain version :func:`bsr_bp_int8_plain` for CPU
    tensors.  Its arithmetic is :mod:`.bp_int8`'s, bit for bit; its early
    exit is K1's, per shot block.
  * :class:`BSRBPDecoder` is the decoder object (``check_perm`` /
    ``var_perm``, outputs in the original column order; ``msg_dtype``
    ``"bfloat16"`` for K1, ``"int8"`` for K5).

On the card both kernels split each phase of an iteration (A checks, B
variables, C parity) over a flat list of (row, shot vector) items and a
grid sized from the item count and the SM count
(``utils/cuda_build.py::bsr_plan``, computed here before the launch and
tested on the CPU).  One call of the C entry point enqueues the whole
decode, at most three grids per iteration, and the host reads nothing
back: the early exit lives in device memory (``gbad``, one "unconverged"
mark per shot block and iteration, and a ``done`` word after which every
later grid returns at once).  The shot axis is padded to a multiple of 16
with all-zero syndromes that never count towards the exit, and the outputs
are cut back.  Where every phase's grid fits the card at once (min-sum at
a few hundred shots: the host redecode), K1 runs the same phases in one
cooperative launch with grid-wide barriers (route "coop"; else "grids").
Checks of more than 32 slots (detector-error-model fault matrices) take
route "wide": the check phase scans a check's slots twice (sign and phi
total, or sign, min1, min2 and argmin; then the outgoing messages), so a
thread's registers do not grow with the degree.
``KERNEL.launches`` / ``KERNEL_INT8.launches`` count decodes, ``routes``
split them by route.

K1 keeps the TPU kernel's profiling hook ``ablate`` (``bp_bsr.py:231-236``,
driven by ``experiments/bench_bsr_ablation.py``): ``"no_check"`` skips the
check update (the variable update reads the v2c messages as c2v);
``"no_route"`` replaces the variable update and the parity by a copy (the
posterior is the prior, every message is negated, the parity is 0, so a
shot converges exactly where its syndrome is zero).  As in JAX, an
ablation turns the min-sum dead-plane rule off (every padded slot is
rewritten, as for sum-product) and never takes the cooperative route.
Production callers leave it empty; K5 has none (nor has the JAX
``_kernel_int8``).

Numerics follow the TPU kernel (``bp_bsr.py:226-543``):

  * the initial v2c message is bf16(prior[var]); padded slots hold
    bf16(+BIG);
  * the check update computes in f32 on the bf16 messages and stores c2v in
    bf16.  Min-sum scans a check's slots in order with the first minimum
    winning the tie; sum-product totals phi over all Dc slots, phi(+BIG)
    included.  A padded slot is rewritten by the edge broadcast (to
    bf16(BIG - c2v)) where the TPU kernel rewrites it: in every plane for
    sum-product, in the planes below the chunk's live-slot count for
    min-sum (``live_slots``, per 128-check chunk);
  * the posterior is the f32 prior plus the bf16 c2v messages, accumulated
    in f32 in the variable's edge order;
  * the edge broadcast uses bf16(posterior): v2c = bf16(bf16(post) - c2v);
  * the parity of bf16(posterior) is checked every iteration when
    ``early_stop`` is set, and once after the loop otherwise; the hard
    decision is the f32 posterior's sign.

The early exit is per shot block, as on the TPU: the kernel resets its
done flag at every grid step (one block of ``shot_block`` shots), so a
block stops once all ITS shots have converged, and ``iters`` is constant
within a block.  The block size resolves as in JAX: ``shot_block``
(default :func:`auto_shot_block`), clamped to ``round_up(S, 128)``.  The
TPU pads the last block with zero-syndrome shots; with priors below 1/2
such a shot converges at every iteration, so the port, whose padded shots
never count, exits where the TPU does.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from scipy import sparse

from ..convert import TannerTables, tanner_tables
from ..utils.cuda_build import BSR_ROUTES, CudaKernel, aligned, bsr_plan
from ..utils.device import DeviceLike, resolve_device
from .bp import (BIG, DecoderBase, alpha_at, channel_priors, check_update_cm,
                 normalize_method, priors_to_llr, syndrome_ok)
from .bp_int8 import (alpha_num_of, int8_step, int8_syndrome_ok, int8_v2c0,
                      quantize_priors)
from .tanner import TannerELL

__all__ = ["BSRLayout", "auto_shot_block", "bsr_bp_decode", "bsr_bp_plain",
           "bsr_bp_decode_int8", "bsr_bp_int8_plain", "BSRBPDecoder", "KERNEL", "KERNEL_INT8",
           "ABLATIONS"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# csrc/bsr_bp.cu::bsr_bp_run: 11 arrays; C, V, Dc, Dv, S, S_live, sb, G, method; alpha;
# adaptive, n_iter, (vec, blocks) of the three phases, route, ablate; the stream.
KERNEL = CudaKernel("bsr_bp.cu", "bsr_bp_run", [_P] * 11 + [_I] * 9 + [_F] + [_I] * 10 + [_P])
# csrc/bsr_bp_int8.cu::bsr_bp_int8_run: 10 arrays; C, V, Dc, Dv, S, S_live, sb, G,
# alpha_num, n_iter, (vec, blocks) of the three phases, route; the stream.
KERNEL_INT8 = CudaKernel("bsr_bp_int8.cu", "bsr_bp_int8_run", [_P] * 10 + [_I] * 17 + [_P])

_TILE = 128
_BF16 = torch.bfloat16
# K1 takes its cooperative route where the plan finds it fits (min-sum at the
# host redecode's sizes); False keeps every decode on one grid per phase
# (for comparisons of the two routes).
COOPERATIVE = True
# K1's profiling hook: the ablation's name -> csrc/bsr_bp.cu's BSR_FULL, BSR_NO_CHECK, BSR_NO_ROUTE
ABLATIONS = {"": 0, "no_check": 1, "no_route": 2}


def _check_ablate(ablate: str) -> str:
    if ablate not in ABLATIONS:
        raise ValueError(f"unknown ablate {ablate!r}: expected one of {sorted(ABLATIONS)}")
    return ablate


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True, eq=False)
class BSRLayout:
    """What the port keeps of the JAX ``BSRSchedule``: the Tanner tables on
    the device, the padded sizes and tile count that size the JAX shot
    block (:func:`auto_shot_block`), and the live-slot count of every
    128-check chunk (the min-sum scan and broadcast bounds)."""

    tables: TannerTables
    c_pad: int
    v_pad: int
    num_tiles: int
    live_slots: Tuple[int, ...]
    _limits: Dict[str, torch.Tensor] = field(default_factory=dict, repr=False)

    @property
    def num_checks(self) -> int:
        return self.tables.num_checks

    @property
    def num_vars(self) -> int:
        return self.tables.num_vars

    @property
    def e_pad(self) -> int:
        return self.tables.max_check_degree * self.c_pad

    @property
    def device(self) -> torch.device:
        return self.tables.device

    @classmethod
    def from_tanner(cls, tanner, device: DeviceLike = "cuda") -> "BSRLayout":
        """Tile count and live slots as ``bp_bsr.py::_build_schedule`` finds them."""
        C, V, Dc = tanner.num_checks, tanner.num_vars, tanner.max_check_degree
        C_pad, V_pad = _round_up(C, _TILE), _round_up(V, _TILE)
        chk_vars = np.asarray(tanner.chk_vars)
        chk_mask = np.asarray(tanner.chk_mask)
        c_idx, s_idx = np.nonzero(chk_mask)
        erow = s_idx.astype(np.int64) * C_pad + c_idx
        vt = chk_vars[c_idx, s_idx].astype(np.int64) // _TILE
        num_tiles = int(np.unique(vt * (Dc * C_pad // _TILE) + erow // _TILE).shape[0])
        deg = np.zeros(C_pad, np.int64)
        deg[:C] = chk_mask.sum(axis=1)
        live = tuple(int(deg[i:i + _TILE].max()) for i in range(0, C_pad, _TILE))
        return cls(tanner_tables(tanner, resolve_device(device)), C_pad, V_pad, num_tiles, live)

    def slot_limits(self, method: str) -> torch.Tensor:
        """(C,) int32: per check, the slots below which a padded slot is
        rewritten by the broadcast (the chunk's live slots for min-sum, all
        Dc for sum-product).  Made once per method: a copy to the card per
        decode would wait on the stream."""
        if method not in self._limits:
            if method == "ps":
                lim = np.full(self.num_checks, self.tables.max_check_degree)
            else:
                lim = np.repeat(np.asarray(self.live_slots), _TILE)[: self.num_checks]
            self._limits[method] = torch.as_tensor(lim.astype(np.int32)).to(self.device)
        return self._limits[method]


def auto_shot_block(layout: BSRLayout) -> int:
    """The JAX package's default shot block (``bp_bsr.py::_auto_shot_block``):
    256 where its VMEM estimate stays under 56 MiB, else 128.  On the card
    it is the unit of the early exit, not a memory choice."""
    sb = 256
    msg = 2 * layout.e_pad * sb
    state = 4 * sb * (layout.v_pad + 2 * layout.c_pad) + 16 * layout.c_pad * sb
    onehots = layout.num_tiles * _TILE * _TILE * 2
    temps = 4 * 8 * _TILE * sb
    return sb if msg + state + onehots + temps < 56 * 2**20 else 128


def _blocks(shot_block: int, S: int) -> Tuple[int, int]:
    """(shots per block, number of blocks) for S shots: JAX clamps the block
    to round_up(S, 128) so a small batch is not padded to a large block."""
    sb = max(1, min(int(shot_block), _round_up(S, _TILE)))
    return sb, -(-S // sb)


def _parity_ok(post: torch.Tensor, synd: torch.Tensor, t: TannerTables) -> torch.Tensor:
    """(S,) bool: the parity of bf16(post)'s hard decision equals ``synd``."""
    return syndrome_ok((post.to(_BF16) <= 0).to(torch.uint8), synd, t)


def _bsr_iter_plain(t: TannerTables, msg, synd_sign, prior, method: str, alpha: float,
                    rewrite_pad, ablate: str = ""):
    """One flooding iteration on every shot: msg (C, Dc, S) bf16 v2c ->
    (new msg (C, Dc, S) bf16, posterior (V, S) f32); ``ablate`` as
    :func:`bsr_bp_decode`'s."""
    C, Dc, S = msg.shape
    Dv = t.max_var_degree
    if ablate == "no_check":
        c2v = msg.float()
    else:
        c2v = check_update_cm(msg.float(), synd_sign, method, alpha).to(_BF16).float()
    if ablate == "no_route":   # the TPU kernel's copy-through stand-in (bp_bsr.py:413-423)
        return (-c2v).to(_BF16), prior[:, None].expand(t.num_vars, S)
    zero_row = torch.zeros((1, S), device=msg.device)
    g = torch.cat([c2v.reshape(C * Dc, S), zero_row])[t.vm_from_cm]      # (V, Dv, S)
    total = prior[:, None] + g[:, 0]
    for j in range(1, Dv):
        total = total + g[:, j]
    pb = total.to(_BF16).float()
    live = (pb[t.chk_vars] - c2v).to(_BF16)
    pad = (BIG - c2v).to(_BF16)
    new = torch.where(t.chk_mask[:, :, None], live,
                      torch.where(rewrite_pad[:, :, None], pad, msg))
    return new, total


def _iterate_shot_blocks(step, parity_ok, msg, post, max_iter: int, early_stop: bool,
                         shot_block: int):
    """The iteration loop both plain versions share: ``step(it, msg)`` gives
    (new msg (C, Dc, S), new posterior (V, S)) for every shot, and a shot
    block (``shot_block`` shots, clamped as in JAX) whose shots all satisfy
    ``parity_ok(post)`` stops updating.  Returns (posterior, conv, iters)."""
    S = post.shape[1]
    dev = post.device
    sb, G = _blocks(shot_block, S)
    grp = torch.arange(S, device=dev) // sb
    running = torch.ones(G, dtype=torch.bool, device=dev)
    iters_g = torch.zeros(G, dtype=torch.int32, device=dev)
    for it in range(max_iter):
        if early_stop and not bool(running.any()):
            break
        new_msg, new_post = step(it, msg)
        run = running[grp]
        msg = torch.where(run[None, None], new_msg, msg)
        post = torch.where(run[None], new_post, post)
        iters_g += running.to(torch.int32)
        if early_stop:
            bad = (~parity_ok(post)).to(torch.int32)
            bad_g = torch.zeros(G, dtype=torch.int32, device=dev).index_add_(0, grp, bad)
            running = running & (bad_g > 0)
    return post, parity_ok(post), iters_g[grp]


def bsr_bp_plain(layout: BSRLayout, prior_llr: torch.Tensor, syndromes: torch.Tensor,
                 method: str, max_iter: int, ms_scaling_factor: float,
                 early_stop: bool = True, shot_block: int = 128, ablate: str = ""):
    """Plain version of K1 on the tensors' device; same arguments and
    outputs as :func:`bsr_bp_decode`.  All shots iterate together; a shot
    block whose shots have all converged stops updating."""
    method = normalize_method(method)
    ablate = _check_ablate(ablate)
    t = layout.tables
    C, V, Dc = t.num_checks, t.num_vars, t.max_check_degree
    S = syndromes.shape[1]
    dev = syndromes.device
    prior = prior_llr.to(device=dev, dtype=torch.float32)
    synd = syndromes.to(torch.uint8)
    synd_sign = 1.0 - 2.0 * synd.to(torch.float32)
    slot = torch.arange(Dc, device=dev)
    rewrite_pad = ~t.chk_mask & (slot[None, :] < _slot_limits(layout, method, ablate)[:, None])
    edge_prior = torch.where(t.chk_mask, prior[t.chk_vars], BIG).to(_BF16)
    msg = edge_prior[:, :, None].expand(C, Dc, S).contiguous()
    if ablate == "no_route":   # the stand-in zeroes the parity: only a zero syndrome passes
        zero_synd = (synd == 0).all(dim=0)
        parity_ok = lambda p: zero_synd   # noqa: E731
    else:
        parity_ok = lambda p: _parity_ok(p, synd, t)   # noqa: E731
    post, conv, iters = _iterate_shot_blocks(
        lambda it, m: _bsr_iter_plain(t, m, synd_sign, prior, method,
                                      alpha_at(it, ms_scaling_factor), rewrite_pad, ablate),
        parity_ok, msg, prior[:, None].expand(V, S).clone(), max_iter, early_stop, shot_block)
    return (post <= 0).to(torch.uint8), post, conv, iters


def _slot_limits(layout: BSRLayout, method: str, ablate: str) -> torch.Tensor:
    """The padded-slot rewrite table of a decode: the JAX kernel turns its
    min-sum dead-plane skipping off under an ablation (``bp_bsr.py:263``),
    so every padded slot is rewritten there, as for sum-product."""
    return layout.slot_limits("ps" if ablate else method)


def bsr_bp_decode(layout: BSRLayout, prior_llr: torch.Tensor, syndromes: torch.Tensor,
                  method: str, max_iter: int, ms_scaling_factor: float,
                  early_stop: bool = True, shot_block: int = 128, ablate: str = ""):
    """syndromes (C, S) 0/1 -> (hard (V, S) uint8, posterior (V, S) f32,
    converged (S,) bool, iters (S,) int32), the JAX ``bsr_bp_decode``
    contract with its early exit per block of ``shot_block`` shots.

    CPU tensors run :func:`bsr_bp_plain`.  On a CUDA device one call of
    kernel K1 runs the whole decode (at most three grids per iteration);
    with ``early_stop`` a shot block skips every iteration after the first
    that left none of its shots unconverged, and once every block has
    stopped the remaining grids return at once, all without a host
    synchronisation.

    ``ablate`` is the TPU kernel's profiling hook (module docstring):
    ``""`` (every production caller), ``"no_check"`` or ``"no_route"``;
    another value raises."""
    method = normalize_method(method)
    ablate = _check_ablate(ablate)
    dev = syndromes.device
    if dev.type == "cpu":
        return bsr_bp_plain(layout, prior_llr, syndromes, method, max_iter,
                            ms_scaling_factor, early_stop, shot_block, ablate)
    prior, S = _check_call("bsr_bp_decode", layout, prior_llr, syndromes, max_iter,
                           torch.float32, "prior_llr")
    if S == 0:  # a grid of no blocks is not a launch
        return _no_shots(layout.num_vars, torch.float32, dev)
    st = _CardDecode(layout, syndromes, max_iter, early_stop, shot_block, int8=False,
                     coop=COOPERATIVE and method == "ms", ablate=ablate)
    t, plan = layout.tables, st.plan
    msf = float(ms_scaling_factor)
    KERNEL.launch(
        t.chk_vars_k.data_ptr(), t.vm_k.data_ptr(),
        _slot_limits(layout, method, ablate).data_ptr(), *st.pointers(prior), *st.shape_args(),
        0 if method == "ps" else 1, msf, int(msf == 0.0), int(max_iter), *st.grid_args(),
        BSR_ROUTES[plan.route], ABLATIONS[ablate], torch.cuda.current_stream(dev).cuda_stream,
        route=plan.route)
    return st.outputs()


def _check_call(name: str, layout: BSRLayout, prior: torch.Tensor, syndromes: torch.Tensor,
                max_iter: int, dtype: torch.dtype, prior_name: str):
    """The checks both card wrappers make before a launch; returns the
    priors as the kernel reads them and the shot count."""
    dev = syndromes.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    t = layout.tables
    C, V = t.num_checks, t.num_vars
    Cs, S = syndromes.shape
    if Cs != C:
        raise ValueError(f"syndromes have {Cs} rows, expected {C}")
    if t.device != dev or prior.device != dev:
        raise ValueError(f"{name}: tables, priors and syndromes must share one device")
    prior = prior.to(dtype).contiguous()
    if prior.shape != (V,):
        raise ValueError(f"{prior_name} must have shape ({V},)")
    if max_iter <= 0:
        raise ValueError(f"{name} needs max_iter >= 1, got {max_iter}")
    return prior, S


class _CardDecode:
    """The plan and the device state of one K1 or K5 decode: syndromes
    padded to the plan's shot count (all-zero columns), the messages, the
    posterior, conv and the hard-decision bytes, and with ``early_stop`` one
    zeroed int32 buffer that holds the ``done``/ticket flags and the
    (max_iter, groups) ``gbad`` table."""

    def __init__(self, layout: BSRLayout, syndromes: torch.Tensor, max_iter: int,
                 early_stop: bool, shot_block: int, int8: bool, coop: bool = False,
                 ablate: str = ""):
        t = layout.tables
        dev = syndromes.device
        C, V = t.num_checks, t.num_vars
        S = syndromes.shape[1]
        sb, _G = _blocks(shot_block, S)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        self.plan = plan = bsr_plan(C, V, t.max_check_degree, t.max_var_degree, S, sb, sms, int8,
                                    coop, ablate)
        Sp = plan.shots
        synd = syndromes.to(torch.uint8)
        if Sp != S or not synd.is_contiguous() or not aligned(synd):
            synd = torch.zeros((C, Sp), dtype=torch.uint8, device=dev)
            synd[:, :S] = syndromes
        self.synd = synd
        self.msg = torch.empty((C * t.max_check_degree, Sp),
                               dtype=torch.int8 if int8 else _BF16, device=dev)
        self.post = torch.empty((V, Sp), dtype=torch.int32 if int8 else torch.float32, device=dev)
        self.conv = torch.empty((Sp,), dtype=torch.uint8, device=dev)
        self.hard = torch.empty((V, Sp), dtype=torch.uint8, device=dev)
        self.flags = self.gbad = None
        if early_stop:
            state = torch.zeros(2 + max_iter * plan.groups, dtype=torch.int32, device=dev)
            self.flags, self.gbad = state[:2], state[2:].view(max_iter, plan.groups)
        self.max_iter = int(max_iter)
        self.dims = (C, V, t.max_check_degree, t.max_var_degree)

    def pointers(self, prior: torch.Tensor):
        """synd, prior, msg, post, conv, hard, gbad, flags (null without the exit)."""
        opt = [None if x is None else x.data_ptr() for x in (self.gbad, self.flags)]
        return (self.synd.data_ptr(), prior.data_ptr(), self.msg.data_ptr(),
                self.post.data_ptr(), self.conv.data_ptr(), self.hard.data_ptr(), *opt)

    def shape_args(self):
        """C, V, Dc, Dv, S (padded), S_live, sb, G."""
        p = self.plan
        return (*self.dims, p.shots, p.live, p.shot_block, p.groups)

    def grid_args(self):
        p = self.plan
        return (p.checks.vec, p.checks.blocks, p.variables.vec, p.variables.blocks,
                p.parity.vec, p.parity.blocks)

    def outputs(self):
        """(hard, posterior, converged, iters) of the caller's shots."""
        S, dev = self.plan.live, self.post.device
        post = self.post[:, :S].contiguous()
        if self.gbad is None:
            iters = torch.full((S,), self.max_iter, dtype=torch.int32, device=dev)
        else:
            iters = _block_iters(self.gbad, self.max_iter, self.plan.shot_block, S)
        return (post <= 0).to(torch.uint8), post, self.conv[:S].bool(), iters


def _no_shots(V: int, post_dtype: torch.dtype, dev: torch.device):
    """The decode of an empty batch: (hard, posterior, converged, iters)."""
    return (torch.empty((V, 0), dtype=torch.uint8, device=dev),
            torch.empty((V, 0), dtype=post_dtype, device=dev),
            torch.empty((0,), dtype=torch.bool, device=dev),
            torch.empty((0,), dtype=torch.int32, device=dev))


def _block_iters(gbad: torch.Tensor, max_iter: int, sb: int, S: int) -> torch.Tensor:
    """(S,) int32 from the kernels' (max_iter, G) "unconverged" table: shot
    block g ran until the first iteration that left it no shot unconverged."""
    iters_g = ((gbad != 0).sum(dim=0) + 1).clamp(max=max_iter).to(torch.int32)
    return iters_g[torch.arange(S, device=gbad.device) // sb]


def bsr_bp_int8_plain(layout: BSRLayout, prior_q: torch.Tensor, syndromes: torch.Tensor,
                      max_iter: int, alpha_num: int, early_stop: bool = True,
                      shot_block: int = 128):
    """Plain version of K5 on the tensors' device; same arguments and
    outputs as :func:`bsr_bp_decode_int8`.  The iteration is
    :func:`.bp_int8.int8_step`; all shots iterate together, and a shot block
    whose shots have all converged stops updating."""
    t = layout.tables
    S = syndromes.shape[1]
    prior_q = prior_q.to(device=syndromes.device, dtype=torch.int32)
    synd = syndromes.to(torch.int32)
    post, conv, iters = _iterate_shot_blocks(
        lambda _it, m: int8_step(t, m, synd, prior_q, int(alpha_num)),
        lambda p: int8_syndrome_ok(p, synd, t), int8_v2c0(t, prior_q, S),
        prior_q[:, None].expand(t.num_vars, S).clone(), max_iter, early_stop, shot_block)
    return (post <= 0).to(torch.uint8), post, conv, iters


def bsr_bp_decode_int8(layout: BSRLayout, prior_q: torch.Tensor, syndromes: torch.Tensor,
                       max_iter: int, alpha_num: int, early_stop: bool = True,
                       shot_block: int = 128):
    """int8 fixed-point min-sum decode, the JAX ``bsr_bp_decode_int8``
    contract: ``prior_q`` (V,) int32 quanta (:func:`.bp_int8.quantize_priors`),
    syndromes (C, S) 0/1 -> (hard (V, S) uint8, posterior (V, S) int32
    quanta, converged (S,) bool, iters (S,) int32); scale the posterior by
    delta for LLR units.  The early exit is per block of ``shot_block``
    shots, clamped to ``round_up(S, 128)``.

    CPU tensors run :func:`bsr_bp_int8_plain`.  On a CUDA device one call of
    kernel K5 runs the whole decode, its loop and exit on the device as
    K1's."""
    dev = syndromes.device
    if dev.type == "cpu":
        return bsr_bp_int8_plain(layout, prior_q, syndromes, max_iter, alpha_num, early_stop,
                                 shot_block)
    prior, S = _check_call("bsr_bp_decode_int8", layout, prior_q, syndromes, max_iter,
                           torch.int32, "prior_q")
    if S == 0:  # a grid of no blocks is not a launch
        return _no_shots(layout.num_vars, torch.int32, dev)
    st = _CardDecode(layout, syndromes, max_iter, early_stop, shot_block, int8=True)
    t = layout.tables
    KERNEL_INT8.launch(
        t.chk_vars_k.data_ptr(), t.vm_k.data_ptr(), *st.pointers(prior), *st.shape_args(),
        int(alpha_num), int(max_iter), *st.grid_args(), BSR_ROUTES[st.plan.route],
        torch.cuda.current_stream(dev).cuda_stream, route=st.plan.route)
    return st.outputs()


@dataclass
class BSRBPDecoder(DecoderBase):
    """Batched flat BP on kernel K1 (early exit per shot block); the same
    ``decode_batch`` contract as :class:`.bp.BPDecoder`.
    ``check_perm``/``var_perm`` (new -> old) pre-permute H; outputs return
    in the ORIGINAL column order.

    ``msg_dtype="int8"`` decodes on kernel K5 instead: fixed-point min-sum
    with a fixed scaling factor, priors quantized to ``prior_quanta`` quanta
    (:func:`.bp_int8.quantize_priors`), the posterior returned in LLR units.
    :func:`.select.make_bp_decoder` never chooses it."""

    layout: BSRLayout
    prior_llr: np.ndarray     # in the permuted column order
    method: str = "ps"
    max_iter: int = 0
    ms_scaling_factor: float = 0.0
    early_stop: bool = True
    shot_block: Optional[int] = None   # None -> auto_shot_block
    check_perm: Optional[np.ndarray] = None
    inv_var_perm: Optional[np.ndarray] = None  # old -> new
    msg_dtype: str = "bfloat16"
    prior_quanta: int = 24

    def __post_init__(self):
        self.method = normalize_method(self.method)
        if self.max_iter <= 0:
            self.max_iter = self.layout.num_vars
        if self.msg_dtype not in ("bfloat16", "int8"):
            raise ValueError(f"unknown msg_dtype {self.msg_dtype!r}")
        if self.shot_block is None:
            self.shot_block = auto_shot_block(self.layout)
        dev = self.layout.device
        if self.msg_dtype == "int8":
            if self.method != "ms":
                raise ValueError("int8 BSR supports min-sum only")
            if not 0 < self.ms_scaling_factor <= 1:
                raise ValueError("int8 BSR needs a fixed scaling factor in (0, 1]")
            q, self._delta = quantize_priors(self.prior_llr, self.prior_quanta)
            self._prior_q = torch.as_tensor(q).to(dev)
        self._prior = torch.as_tensor(np.asarray(self.prior_llr, dtype=np.float32)).to(dev)
        self._check_perm = None if self.check_perm is None else torch.as_tensor(
            np.asarray(self.check_perm, dtype=np.int64)).to(dev)
        self._inv_var_perm = None if self.inv_var_perm is None else torch.as_tensor(
            np.asarray(self.inv_var_perm, dtype=np.int64)).to(dev)

    @property
    def device(self) -> torch.device:
        return self.layout.device

    @classmethod
    def from_check_matrix(cls, H, *, error_rate: Optional[float] = None,
                          channel_probs: Optional[np.ndarray] = None, max_iter: int = 0,
                          bp_method: str = "ps", ms_scaling_factor: float = 0.0,
                          early_stop: bool = True, shot_block: Optional[int] = None,
                          check_perm: Optional[np.ndarray] = None,
                          var_perm: Optional[np.ndarray] = None,
                          msg_dtype: str = "bfloat16", prior_quanta: int = 24,
                          device: DeviceLike = "cuda") -> "BSRBPDecoder":
        H = sparse.csr_matrix(H)
        if check_perm is not None:
            check_perm = np.asarray(check_perm, dtype=np.int64)
            H = H[check_perm]
        inv_var_perm = None
        if var_perm is not None:
            var_perm = np.asarray(var_perm, dtype=np.int64)
            H = H[:, var_perm]
            inv_var_perm = np.empty_like(var_perm)
            inv_var_perm[var_perm] = np.arange(var_perm.shape[0])
        layout = BSRLayout.from_tanner(TannerELL.from_check_matrix(H),
                                       resolve_device(device))
        prior = channel_priors(layout.num_vars, error_rate, channel_probs)
        if var_perm is not None:
            prior = prior[var_perm]
        return cls(layout, priors_to_llr(prior), bp_method, max_iter, float(ms_scaling_factor),
                   early_stop, shot_block, check_perm, inv_var_perm, msg_dtype, prior_quanta)

    def decode_tensors(self, syndromes: torch.Tensor):
        """(C, S) device syndromes in the original check order -> (hard,
        posterior, conv, iters) with rows in the original column order."""
        if self._check_perm is not None:
            syndromes = syndromes[self._check_perm]
        if self.msg_dtype == "int8":
            hard, post, conv, iters = bsr_bp_decode_int8(
                self.layout, self._prior_q, syndromes, self.max_iter,
                alpha_num_of(self.ms_scaling_factor), self.early_stop, self.shot_block)
            post = post.to(torch.float32) * self._delta
        else:
            hard, post, conv, iters = bsr_bp_decode(
                self.layout, self._prior, syndromes, self.method, self.max_iter,
                self.ms_scaling_factor, self.early_stop, self.shot_block)
        if self._inv_var_perm is not None:
            hard, post = hard[self._inv_var_perm], post[self._inv_var_perm]
        return hard, post, conv, iters
