"""Kernel K4: check-partition ("model-parallel") BP for large codes.

Counterpart of ``exp_ldpc_tpu/decoders/bp_bsr_shard.py``.  The check rows
are cut into 128-row chunks, split contiguously over D shards; each shard
owns the syndromes and c2v messages of its checks over the GLOBAL variable
space.  One BP iteration factors at the posterior: given the replicated
posterior, everything else is local, so an iteration is one launch of K4
per shard (:func:`bsr_shard_iter`: broadcast, check update, partial
variable totals; two grids, ``csrc/bsr_shard.cu``) followed by one sum of
the (V_pad, S) partials over the shards, an ``all_reduce`` over the mesh's
model group.

  * :class:`ShardedBSR` is the host build: per shard its check->variable
    table, mask and live slots per chunk, and the variable-major table of
    its local edges.
  * :func:`bsr_shard_iter` is K4: the CUDA kernel ``csrc/bsr_shard.cu`` for
    CUDA tensors, its plain version :func:`bsr_shard_iter_plain` for CPU
    tensors, and nothing else.
  * :class:`ShardedBSRDecoder` decodes, fixed-iteration only: with
    ``mesh=None`` all D shards run in order on one device ("emulation");
    with a mesh each rank runs its model shard on its data shard of shots.

Numerics are the TPU kernel's (``bp_bsr_shard.py:200-306``), which are not
K1's: the carried message is c2v (zero at iteration 0);
v2c = bf16((live ? bf16(posterior) : 1e30) - c2v); for min-sum a plane
with no edge (slot >= its chunk's live slots) is pinned to bf16(1e30) and
skipped by the scan, sum-product scans all Dc slots; the check update runs
in f32 and stores c2v in bf16; the partials are f32 sums of c2v in edge
order with no prior, grouped by 128-row edge tile as the TPU tile products
group them; posterior = prior + the sum of the shards' partials in shard
order; the hard decision and the final parity use the f32 posterior; with
``ms_scaling_factor == 0`` the min-sum scaling is adaptive per iteration.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
from scipy import sparse

from ..parallel.mesh import (DATA_AXIS, MODEL_AXIS, Mesh, all_gather_cols, all_reduce_sum)
from ..utils.cuda_build import MAX_SLOTS, WIDE_VECS, CudaKernel, aligned, row_shot_plan
from ..utils.device import DeviceLike, resolve_device
from .bp import BIG, alpha_at, channel_priors, normalize_method, phi, priors_to_llr

__all__ = ["ShardedBSR", "ShardTables", "ShardedBSRDecoder", "auto_num_shards",
           "bsr_shard_iter", "bsr_shard_iter_plain", "allreduce_bytes", "KERNEL"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# csrc/bsr_shard.cu::bsr_shard: 9 arrays; Cl, Dc, V_pad, n_loc, Dv, S, method; alpha;
# accumulate, (vec, blocks, wide) of the check phase, (vec, blocks) of the variable phase;
# the stream.  One call = one iteration of one shard = 2 grids: ``KERNEL.launches`` counts
# calls, ``KERNEL.routes`` splits them by the check phase's route.
KERNEL = CudaKernel("bsr_shard.cu", "bsr_shard", [_P] * 9 + [_I] * 7 + [_F] + [_I] * 6 + [_P])

_TILE = 128
_BF16 = torch.bfloat16
# On a CUDA device the decoder pads its shot axis to this multiple (all-zero
# syndromes), so that every row starts on a 16-byte boundary and the kernels
# take their vector paths.
_SHOT_ALIGN = 8


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True, eq=False)
class ShardedBSR:
    """Host build: the check rows in 128-row chunks split contiguously over
    D shards, with a uniform padded check count ``c_pad_loc`` and check
    degree ``dc``.  Per shard (leading axis D):

      chk_vars    (D, c_pad_loc, dc) int32, global variable per local slot
      chk_mask    (D, c_pad_loc, dc) bool
      live_slots  (D, c_pad_loc // 128) int32, max check degree per chunk
      vm_local    (D, v_pad, dv) int32, each variable's local edge rows
                  (slot-major: slot * c_pad_loc + local check) in ascending
                  order, pad = e_loc (one past the end)
    """

    num_checks: int
    num_vars: int
    num_shards: int
    c_pad_loc: int
    dc: int
    chk_vars: np.ndarray
    chk_mask: np.ndarray
    live_slots: np.ndarray
    vm_local: np.ndarray

    @property
    def v_pad(self) -> int:
        return _round_up(self.num_vars, _TILE)

    @property
    def e_loc(self) -> int:
        return self.dc * self.c_pad_loc

    @property
    def dv(self) -> int:
        return self.vm_local.shape[2]

    @classmethod
    def from_check_matrix(cls, H, num_shards: int) -> "ShardedBSR":
        H = sparse.csr_matrix(H).copy()
        H.data = H.data % 2
        H.eliminate_zeros()
        H.sort_indices()
        C, V = H.shape
        D = int(num_shards)
        n_cc = _round_up(C, _TILE) // _TILE
        c_pad_loc = -(-n_cc // D) * _TILE
        deg = np.diff(H.indptr)
        Dc = int(deg.max(initial=1))
        c = np.repeat(np.arange(C), deg)                     # check of every edge
        slot = np.arange(H.nnz) - H.indptr[c]
        d, cl = np.divmod(c, c_pad_loc)
        v = H.indices.astype(np.int64)
        chk_vars = np.zeros((D, c_pad_loc, Dc), np.int32)
        chk_mask = np.zeros((D, c_pad_loc, Dc), bool)
        chk_vars[d, cl, slot] = v
        chk_mask[d, cl, slot] = True
        deg_pad = np.zeros(D * c_pad_loc, np.int64)
        deg_pad[:C] = deg
        live = deg_pad.reshape(D, c_pad_loc // _TILE, _TILE).max(axis=2).astype(np.int32)
        # variable-major local edges, ascending edge row within (shard, variable)
        erow = slot * c_pad_loc + cl
        order = np.lexsort((erow, v, d))
        d_o, v_o, e_o = d[order], v[order], erow[order]
        key = d_o * V + v_o
        first = np.r_[0, np.nonzero(np.diff(key))[0] + 1] if key.size else np.zeros(0, int)
        pos = np.arange(key.size) - np.repeat(first, np.diff(np.r_[first, key.size]))
        Dv = int(pos.max(initial=0)) + 1
        vm_local = np.full((D, _round_up(V, _TILE), Dv), Dc * c_pad_loc, np.int32)
        vm_local[d_o, v_o, pos] = e_o
        return cls(C, V, D, c_pad_loc, Dc, chk_vars, chk_mask, live, vm_local)

    def tables(self, shard: int, device: DeviceLike = "cuda") -> "ShardTables":
        return ShardTables.build(self, shard, resolve_device(device))

    def shard_syndromes(self, syndromes: torch.Tensor,
                        shots: Optional[int] = None) -> torch.Tensor:
        """(C, S) -> (D, c_pad_loc, shots) uint8, zero rows past the last
        check and zero columns past S (``shots`` defaults to S)."""
        C, S = syndromes.shape
        shots = S if shots is None else shots
        out = torch.zeros((self.num_shards * self.c_pad_loc, shots), dtype=torch.uint8,
                          device=syndromes.device)
        out[:C, :S] = syndromes
        return out.view(self.num_shards, self.c_pad_loc, shots)


@dataclass(frozen=True, eq=False)
class ShardTables:
    """One shard's tables on a device, in the forms the plain version
    (index tensors) and the kernel (flat int32, -1 = pad) read."""

    c_pad_loc: int
    dc: int
    v_pad: int
    dv: int
    chk_idx: torch.Tensor      # (dc, c_pad_loc) int64, global variable (0 on a pad)
    live: torch.Tensor         # (dc, c_pad_loc) bool, a real edge
    nslot_ms: torch.Tensor     # (c_pad_loc,) int32, the chunk's live slots
    nslot_ps: torch.Tensor     # (c_pad_loc,) int32, dc
    lvar: torch.Tensor         # (v_pad,) int64, local variables first, then the rest
    lvm: torch.Tensor          # (n_loc, dv) int64, local edge rows, pad = e_loc
    chk_vars_k: torch.Tensor   # (dc*c_pad_loc,) int32, slot-major, -1 = pad
    lvar_k: torch.Tensor       # (v_pad,) int32
    lvm_k: torch.Tensor        # (n_loc*dv,) int32, -1 = pad
    parity_vars: torch.Tensor  # (c_pad_loc, dc) int64 (check-major, for the parity)
    parity_mask: torch.Tensor  # (c_pad_loc, dc) bool

    @property
    def n_loc(self) -> int:
        return self.lvm.shape[0]

    @property
    def device(self) -> torch.device:
        return self.chk_idx.device

    def nslot(self, method: str) -> torch.Tensor:
        """Slots scanned per check: the chunk's live slots for min-sum, all
        Dc for sum-product."""
        return self.nslot_ps if method == "ps" else self.nslot_ms

    @classmethod
    def build(cls, sb: ShardedBSR, d: int, dev: torch.device) -> "ShardTables":
        cv, cm = sb.chk_vars[d], sb.chk_mask[d]
        vm = sb.vm_local[d]
        has = vm[:, 0] < sb.e_loc
        loc = np.nonzero(has)[0]
        lvar = np.concatenate([loc, np.nonzero(~has)[0]])
        lvm = vm[loc]

        def t(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a)).to(device=dev, dtype=dtype)

        slot_major = np.where(cm, cv, -1).T                   # (dc, c_pad_loc)
        return cls(
            sb.c_pad_loc, sb.dc, sb.v_pad, sb.dv,
            t(np.where(cm, cv, 0).T, torch.int64), t(cm.T, torch.bool),
            t(np.repeat(sb.live_slots[d], _TILE), torch.int32),
            t(np.full(sb.c_pad_loc, sb.dc), torch.int32),
            t(lvar, torch.int64), t(lvm, torch.int64),
            t(slot_major.reshape(-1), torch.int32), t(lvar, torch.int32),
            t(np.where(lvm < sb.e_loc, lvm, -1).reshape(-1), torch.int32),
            t(cv, torch.int64), t(cm, torch.bool))


def auto_num_shards(H, shot_block: int = 128, max_shards: int = 64) -> int:
    """The JAX package's shard count (``bp_bsr_shard.py:155-197``): the
    smallest D in 1, 2, 4, ... whose per-shard TPU kernel fits its 64 MiB
    VMEM estimate (8 for the n = 40,000 capacity code, 1 for codes the fused
    kernel runs).  The port keeps the rule so that its entry points shard
    as the JAX ones do; D changes only the f32 association of the
    posterior."""
    H = sparse.csr_matrix(H)
    C, V = H.shape
    E = H.nnz
    v_pad = _round_up(V, _TILE)
    n_cc = _round_up(C, _TILE) // _TILE
    dc = int(np.diff(H.indptr).max(initial=1))
    D = 1
    while D <= max_shards:
        c_loc = -(-n_cc // D) * _TILE
        e_loc = dc * c_loc
        tiles_loc = int(2.6 * E / 128 / D)
        state = 8 * v_pad * shot_block
        msg = 2 * 2 * e_loc * shot_block
        oh = tiles_loc * _TILE * _TILE * 2
        temps = 4 * 8 * _TILE * shot_block
        if state + msg + oh + temps < 64 * 2**20:
            return D
        D *= 2
    raise ValueError(
        "no shard count fits VMEM: the replicated (V_pad, S) posterior "
        f"alone is {8 * v_pad * shot_block / 2**20:.0f} MiB; reduce shot_block")


def allreduce_bytes(num_shards: int, v_pad: int, shots: int) -> float:
    """Bytes each rank sends per iteration in a ring all-reduce of the
    (v_pad, shots) f32 partials over ``num_shards`` ranks."""
    return 2 * (num_shards - 1) / num_shards * 4 * v_pad * shots


def _check_scan(x: torch.Tensor, synd_sign: torch.Tensor, nslot: torch.Tensor, method: str,
                alpha: float) -> torch.Tensor:
    """Check update of (Dc, Cl, S) f32 v2c planes, slot by slot in order as
    the kernel (``check_update``) scans them; check c scans its first
    ``nslot[c]`` slots (all Dc for sum-product).  Returns the c2v planes;
    slots past ``nslot`` keep their input."""
    Dc = x.shape[0]
    act = [(i < nslot)[:, None] for i in range(Dc)]
    tsign = synd_sign
    for i in range(Dc):
        tsign = torch.where(act[i] & (x[i] < 0), -tsign, tsign)
    out = []
    if method == "ps":
        ph = [phi(x[i].abs()) for i in range(Dc)]
        total = ph[0]
        for i in range(1, Dc):
            total = total + ph[i]
        for i in range(Dc):
            out.append(torch.where(x[i] < 0, -tsign, tsign) * phi(total - ph[i]))
        return torch.stack(out)
    min1 = x[0].abs()
    min2 = torch.full_like(min1, BIG)
    arg = torch.zeros_like(min1, dtype=torch.int64)
    for i in range(1, Dc):
        m = x[i].abs()
        lt = act[i] & (m < min1)
        min2 = torch.where(lt, min1, torch.where(act[i], torch.minimum(min2, m), min2))
        arg = torch.where(lt, i, arg)
        min1 = torch.where(lt, m, min1)
    for i in range(Dc):
        c2v = (torch.where(x[i] < 0, -tsign, tsign) * torch.where(arg == i, min2, min1)) * alpha
        out.append(torch.where(act[i], c2v, x[i]))
    return torch.stack(out)


def bsr_shard_iter_plain(sh: ShardTables, posterior: torch.Tensor, messages: torch.Tensor,
                         syndromes: torch.Tensor, alpha: float, method: str,
                         out: Optional[torch.Tensor] = None,
                         out_part: Optional[torch.Tensor] = None, accumulate: bool = False):
    """Plain version of K4 on the tensors' device; same arguments and
    outputs as :func:`bsr_shard_iter`."""
    Dc, Cl = sh.dc, sh.c_pad_loc
    S = posterior.shape[1]
    nslot = sh.nslot(method)
    pb = posterior.to(_BF16).float()
    acc = torch.where(sh.live[:, :, None], pb[sh.chk_idx], BIG)              # (Dc, Cl, S)
    v2c = (acc - messages.view(Dc, Cl, S).float()).to(_BF16)
    slot = torch.arange(Dc, device=posterior.device)[:, None]
    dead = slot >= nslot[None, :]                                             # (Dc, Cl)
    v2c = torch.where(dead[:, :, None], torch.tensor(BIG, dtype=_BF16, device=v2c.device), v2c)
    synd_sign = 1.0 - 2.0 * syndromes.to(torch.float32)
    c2v = _check_scan(v2c.float(), synd_sign, nslot, method, alpha).to(_BF16)
    flat = torch.cat([c2v.reshape(Dc * Cl, S), torch.zeros((1, S), dtype=_BF16,
                                                           device=c2v.device)]).float()
    # per local variable: sum per 128-row edge tile, tiles in order
    g = flat[sh.lvm]                                                           # (n_loc, Dv, S)
    tile = torch.where(sh.lvm < Dc * Cl, sh.lvm // _TILE, -1)
    tot = torch.zeros((sh.n_loc, S), device=posterior.device)
    run = torch.zeros_like(tot)
    for j in range(sh.dv):
        live = (tile[:, j] >= 0)[:, None]
        new = live & ((tile[:, j] != tile[:, j - 1])[:, None] if j else True)
        if j:
            tot = torch.where(new, tot + run, tot)
        run = torch.where(new, 0.0 + g[:, j], torch.where(live, run + g[:, j], run))
    tot = tot + run
    part = torch.zeros((sh.v_pad, S), device=posterior.device)
    part[sh.lvar[: sh.n_loc]] = tot
    if out_part is not None:
        part = out_part.add_(part) if accumulate else out_part.copy_(part)
    if out is not None:
        out.copy_(c2v.view(Dc * Cl, S))
        return out, part
    return c2v.view(Dc * Cl, S), part


def launch_plans(sh: ShardTables, shots: int, sm_count: int, accumulate: bool = False,
                 vectors: bool = True):
    """Lane width and grid of K4's two phases (``csrc/bsr_shard.cu``): phase
    A walks the shard's checks, phase B every variable (or, accumulating,
    only those with a local edge), each times the shot vectors.  Phase A
    keeps a check's Dc messages of every owned shot in registers, so it
    takes 4 shots a lane up to 16 slots and 2 above; past ``MAX_SLOTS``
    slots it takes route "wide" (the two-pass scan, up to 8 shots a lane);
    phase B takes up to 8.  ``vectors`` is false when an array does not
    start on a 16-byte boundary."""
    wide = sh.dc > MAX_SLOTS
    va = WIDE_VECS if wide else (4,) if sh.dc <= 16 else (2,)
    vb = (8, 4, 2)
    if not vectors:
        va, vb = (), ()
    return (row_shot_plan(sh.c_pad_loc, shots, va, sm_count)._replace(
                route="wide" if wide else "default"),
            row_shot_plan(sh.n_loc if accumulate else sh.v_pad, shots, vb, sm_count))


def bsr_shard_iter(sh: ShardTables, posterior: torch.Tensor, messages: torch.Tensor,
                   syndromes: torch.Tensor, alpha: float, method: str,
                   out: Optional[torch.Tensor] = None,
                   out_part: Optional[torch.Tensor] = None, accumulate: bool = False):
    """One K4 iteration on one shard: posterior (V_pad, S) f32, messages
    (e_loc, S) bf16 (c2v, zeros at iteration 0), syndromes (c_pad_loc, S)
    0/1 -> (messages' (e_loc, S) bf16, partials (V_pad, S) f32, no prior, 0
    for a variable with no local edge).  ``out`` (which may be ``messages``)
    receives the new messages.  ``out_part`` receives the partials, or with
    ``accumulate`` has them added in place (the in-order sum over the
    shards of one device) and is returned in their stead.

    CPU tensors run :func:`bsr_shard_iter_plain`; CUDA tensors launch the
    kernels or raise."""
    method = normalize_method(method)
    dev = posterior.device
    if dev.type == "cpu":
        return bsr_shard_iter_plain(sh, posterior, messages, syndromes, alpha, method, out,
                                    out_part, accumulate)
    if dev.type != "cuda":
        raise ValueError(f"bsr_shard_iter: unsupported device {dev}")
    Dc, Cl, V_pad = sh.dc, sh.c_pad_loc, sh.v_pad
    S = posterior.shape[1]
    if out is None:
        out = torch.empty_like(messages)
    if out_part is None:
        if accumulate:
            raise ValueError("bsr_shard_iter: accumulate needs out_part")
        out_part = torch.empty((V_pad, S), dtype=torch.float32, device=dev)
    for name, x, shape, dtype in (("posterior", posterior, (V_pad, S), torch.float32),
                                  ("messages", messages, (Dc * Cl, S), _BF16),
                                  ("syndromes", syndromes, (Cl, S), torch.uint8),
                                  ("out", out, (Dc * Cl, S), _BF16),
                                  ("out_part", out_part, (V_pad, S), torch.float32)):
        if x.shape != shape or x.dtype != dtype or x.device != dev or not x.is_contiguous():
            raise ValueError(f"bsr_shard_iter: {name} must be a contiguous {dtype} tensor of "
                             f"shape {shape} on {dev}, got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")
    if sh.device != dev:
        raise ValueError("bsr_shard_iter: tables and tensors must share one device")
    if S == 0:
        return out, out_part
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    pa, pb = launch_plans(sh, S, sms, accumulate,
                          aligned(posterior, messages, syndromes, out, out_part))
    KERNEL.launch(
        sh.chk_vars_k.data_ptr(), sh.nslot(method).data_ptr(), sh.lvar_k.data_ptr(),
        sh.lvm_k.data_ptr(), posterior.data_ptr(), messages.data_ptr(), syndromes.data_ptr(),
        out.data_ptr(), out_part.data_ptr(), Cl, Dc, V_pad, sh.n_loc, sh.dv, S,
        0 if method == "ps" else 1, float(alpha), int(accumulate), pa.vec, pa.blocks,
        int(pa.route == "wide"), pb.vec, pb.blocks, torch.cuda.current_stream(dev).cuda_stream,
        route=pa.route)
    return out, out_part


def _parity_bad(sh: ShardTables, hard: torch.Tensor, synd: torch.Tensor) -> torch.Tensor:
    """(S,) int32: this shard's checks whose parity of ``hard`` differs from ``synd``."""
    bits = torch.where(sh.parity_mask[:, :, None], hard[sh.parity_vars], 0).to(torch.int32)
    par = bits.sum(dim=1) % 2
    return (par != synd.to(torch.int32)).to(torch.int32).sum(dim=0, dtype=torch.int32)


@dataclass(eq=False)
class ShardedBSRDecoder:
    """Batched fixed-iteration BP with the checks split over D shards, on K4.

    ``decode_batch`` takes (S, C) syndromes and returns numpy (hard (S, V)
    uint8, posterior (S, V) f32, conv (S,) bool), the JAX contract;
    ``max_iter`` overrides the budget per call.  With ``mesh=None`` the D
    shards run in order on ``device`` and their partials are summed in
    shard order; with a mesh (model axis = D) each rank runs its model
    shard on its data shard of the shots, all-reduces the partials over
    the model group every iteration and the parity counts once at the end,
    and every rank returns the whole batch, gathered over the data group.
    Every rank must call ``decode_batch`` with the same syndromes."""

    sharded: ShardedBSR
    prior_llr: np.ndarray
    mesh: Optional[Mesh] = None
    method: str = "ms"
    max_iter: int = 32
    ms_scaling_factor: float = 0.0
    device: DeviceLike = "cuda"

    def __post_init__(self):
        self.method = normalize_method(self.method)
        sb = self.sharded
        if self.mesh is not None:
            if self.mesh.shape[MODEL_AXIS] != sb.num_shards:
                raise ValueError(f"built for {sb.num_shards} shards but mesh model axis is "
                                 f"{self.mesh.shape[MODEL_AXIS]}")
            self.device = self.mesh.device
            shards = [self.mesh.model_index]
        else:
            self.device = resolve_device(self.device)
            shards = range(sb.num_shards)
        self._shards = list(shards)
        self._tables = [sb.tables(d, self.device) for d in self._shards]
        prior = np.zeros(sb.v_pad, np.float32)
        prior[: sb.num_vars] = np.asarray(self.prior_llr, np.float32)
        self._prior = torch.as_tensor(prior).to(self.device)

    @classmethod
    def from_check_matrix(cls, H, num_shards: int, *, mesh: Optional[Mesh] = None,
                          error_rate: Optional[float] = None,
                          channel_probs: Optional[np.ndarray] = None, max_iter: int = 32,
                          bp_method: str = "ms", ms_scaling_factor: float = 0.0,
                          device: DeviceLike = "cuda") -> "ShardedBSRDecoder":
        sb = ShardedBSR.from_check_matrix(H, num_shards)
        prior = channel_priors(sb.num_vars, error_rate, channel_probs)
        return cls(sb, priors_to_llr(prior), mesh, bp_method, int(max_iter),
                   float(ms_scaling_factor), device)

    def decode_tensors(self, syndromes: torch.Tensor, max_iter: Optional[int] = None,
                       iterate=bsr_shard_iter) -> Tuple[torch.Tensor, torch.Tensor,
                                                        torch.Tensor]:
        """(C, S) syndromes on this decoder's device (this rank's shots on a
        mesh) -> (hard (V_pad, S) uint8, posterior (V_pad, S) f32, conv (S,)
        bool).  ``iterate`` is the per-iteration step; passing
        :func:`bsr_shard_iter_plain` runs the plain version on any device."""
        n_iter = self.max_iter if max_iter is None else int(max_iter)
        sb = self.sharded
        S = syndromes.shape[1]
        dev = self.device
        # the buffers of the whole decode: padded shots decode all-zero syndromes
        Sp = -(-S // _SHOT_ALIGN) * _SHOT_ALIGN if dev.type == "cuda" else S
        synd = sb.shard_syndromes(syndromes, Sp)
        synd = [synd[d] for d in self._shards]
        group = None if self.mesh is None else self.mesh.model_group
        prior = self._prior[:, None]
        post = prior.expand(sb.v_pad, Sp).contiguous()
        tot = torch.empty((sb.v_pad, Sp), dtype=torch.float32, device=dev)
        msgs = [torch.zeros((sb.e_loc, Sp), dtype=_BF16, device=dev) for _ in self._shards]
        for it in range(n_iter):
            alpha = alpha_at(it, self.ms_scaling_factor)
            # shard 0 stores its partials, the others add theirs in shard order:
            # ((p0 + p1) + p2) ..., the sum an in-order loop over the shards takes
            for k, sh in enumerate(self._tables):
                iterate(sh, post, msgs[k], synd[k], alpha, self.method, out=msgs[k],
                        out_part=tot, accumulate=k > 0)
            torch.add(prior, all_reduce_sum(tot, group), out=post)
        hard = (post <= 0).to(torch.uint8)
        bad = torch.zeros(Sp, dtype=torch.int32, device=dev)
        for k, sh in enumerate(self._tables):
            bad = bad + _parity_bad(sh, hard, synd[k])
        conv = all_reduce_sum(bad, group) == 0
        if Sp != S:
            hard, post, conv = hard[:, :S].contiguous(), post[:, :S].contiguous(), conv[:S]
        return hard, post, conv

    def decode_batch(self, syndromes: np.ndarray, max_iter: Optional[int] = None):
        sb = self.sharded
        syndromes = np.asarray(syndromes, dtype=np.uint8)
        S, C = syndromes.shape
        if C != sb.num_checks:
            raise ValueError(f"syndromes have {C} columns, expected {sb.num_checks}")
        n_data = 1 if self.mesh is None else self.mesh.shape[DATA_AXIS]
        S_loc = -(-S // n_data)
        i0 = 0 if self.mesh is None else self.mesh.data_index * S_loc
        synd = np.zeros((C, S_loc), np.uint8)
        mine = syndromes[i0: i0 + S_loc]
        synd[:, : mine.shape[0]] = mine.T
        hard, post, conv = self.decode_tensors(torch.as_tensor(synd).to(self.device), max_iter)
        if self.mesh is not None:
            group = self.mesh.data_group
            hard = all_gather_cols(hard, group)
            post = all_gather_cols(post, group)
            conv = all_gather_cols(conv.to(torch.uint8), group).bool()
        V = sb.num_vars
        return (hard[:V, :S].T.cpu().numpy(), post[:V, :S].T.cpu().numpy(),
                conv[:S].cpu().numpy())
