"""Carry state from the JAX package's host objects into the port's tensors.

The JAX package keeps its decoder and sampler state as numpy arrays on host
objects (``TannerELL``, per-column LLR vectors, ``ParsedCircuit`` op lists,
the fields of a ``StorageDecodePipeline``).  These functions turn that
state into device tensors of the port, so both packages compute the same
thing on the same inputs.  Objects are duck-typed: they may come from
``exp_ldpc_tpu`` itself or from the port's own copies of its host modules.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
from scipy import sparse

from .decoders.tanner import TannerELL
from .utils.device import DeviceLike, resolve_device

__all__ = [
    "TannerTables",
    "tanner_tables",
    "prior_llr_st",
    "DeviceOp",
    "circuit_ops",
    "noise_args",
    "pipeline_kwargs_from_jax",
    "bp_decoder_from_jax",
    "sharded_bsr_decoder_from_jax",
]


@dataclass(frozen=True, eq=False)
class TannerTables:
    """A ``TannerELL`` as device index tensors.

    ``chk_vars``/``chk_mask``/``vm_from_cm``/``cm_from_vm`` keep the JAX
    layouts (pad index one past the end).  ``chk_vars_k`` and ``vm_k`` are
    the flat kernel forms with ``-1`` marking a padded slot.
    """

    num_checks: int
    num_vars: int
    max_check_degree: int
    max_var_degree: int
    chk_vars: torch.Tensor     # (r, Dc) int64 (index tensor)
    chk_mask: torch.Tensor     # (r, Dc) bool
    vm_from_cm: torch.Tensor   # (n, Dv) int64, pad = r*Dc
    cm_from_vm: torch.Tensor   # (r, Dc) int64, pad = n*Dv
    chk_vars_k: torch.Tensor   # (r*Dc,) int32, -1 = padded slot
    vm_k: torch.Tensor         # (n*Dv,) int32 flat check-major slot, -1 = pad

    @property
    def device(self) -> torch.device:
        return self.chk_vars.device


def tanner_tables(tanner, device: DeviceLike = "cuda") -> TannerTables:
    """``TannerELL`` index tables -> device tensors."""
    dev = resolve_device(device)
    r, n = int(tanner.num_checks), int(tanner.num_vars)
    chk_vars = np.asarray(tanner.chk_vars, dtype=np.int64)
    chk_mask = np.asarray(tanner.chk_mask, dtype=bool)
    vm = np.asarray(tanner.vm_from_cm, dtype=np.int64)
    cm = np.asarray(tanner.cm_from_vm, dtype=np.int64)
    Dc, Dv = chk_vars.shape[1], vm.shape[1]
    chk_vars_k = np.where(chk_mask, chk_vars, -1).astype(np.int32).reshape(-1)
    vm_k = np.where(vm < r * Dc, vm, -1).astype(np.int32).reshape(-1)

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=dev, dtype=dtype)

    return TannerTables(
        r, n, Dc, Dv,
        t(chk_vars, torch.int64), t(chk_mask, torch.bool), t(vm, torch.int64),
        t(cm, torch.int64), t(chk_vars_k, torch.int32), t(vm_k, torch.int32),
    )


def prior_llr_st(llr: np.ndarray, device: DeviceLike = "cuda") -> torch.Tensor:
    """Per-spacetime-column LLRs ((rounds+1)·n + rounds·r,) -> f32 tensor."""
    return torch.as_tensor(np.asarray(llr, dtype=np.float32)).to(resolve_device(device))


@dataclass(frozen=True, eq=False)
class DeviceOp:
    """One ``ParsedCircuit`` op with its index tables on the device.

    ``targets`` is the op's target list; two-qubit ops additionally carry
    their pair members ``a``/``b`` (``targets[0::2]``/``targets[1::2]``).
    Correlated channels carry the X- and Z-plane targets of their Pauli
    product.  ``arg_index`` is the op's first slot in the noise vector.
    """

    name: str
    size: int
    targets: torch.Tensor
    a: Optional[torch.Tensor]
    b: Optional[torch.Tensor]
    x_targets: Optional[torch.Tensor]
    z_targets: Optional[torch.Tensor]
    num_args: int
    arg_index: int
    meas_offset: int


_PAIR_OPS = ("CX", "CZ", "DEPOLARIZE2", "PAULI_CHANNEL_2")


def circuit_ops(ops, device: DeviceLike = "cuda", arg_base: int = 0) -> List[DeviceOp]:
    """An op block of a ``ParsedCircuit`` -> :class:`DeviceOp` list; noise
    slots are numbered from ``arg_base`` in :meth:`noise_args` order."""
    dev = resolve_device(device)
    out = []
    ai = arg_base

    def idx(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64)).to(dev)

    for op in ops:
        t = np.asarray(op.targets, dtype=np.int64)
        a = b = xt = zt = None
        if op.name in _PAIR_OPS:
            a, b = idx(t[0::2]), idx(t[1::2])
        if op.name in ("CORRELATED_ERROR", "ELSE_CORRELATED_ERROR"):
            paulis = np.asarray(op.paulis)
            xt = idx(t[(paulis == 1) | (paulis == 2)])
            zt = idx(t[(paulis == 2) | (paulis == 3)])
        k = int(op.num_noise_args)
        out.append(DeviceOp(op.name, int(t.size), idx(t), a, b, xt, zt, k, ai,
                            int(op.meas_offset)))
        ai += k
    return out


def noise_args(parsed, device: DeviceLike = "cuda") -> torch.Tensor:
    """``ParsedCircuit.noise_args()`` as an f32 device tensor."""
    return torch.as_tensor(np.asarray(parsed.noise_args(), dtype=np.float32)).to(
        resolve_device(device))


_BACKENDS = {"auto": "auto", "xla": "stbp", "pallas": "stbp", "stbsr": "stbsr"}


def pipeline_kwargs_from_jax(pipe) -> dict:
    """Constructor arguments of the port's ``StorageDecodePipeline`` from a
    JAX ``StorageDecodePipeline``, as plain numpy/Python values.

    The JAX ``"xla"`` and ``"pallas"`` spacetime backends both compute the
    structured BP that the port's ``"stbp"`` backend computes.  The message
    type and the two-tier budget (``tier2_cap`` as the JAX pipeline resolved
    it) are carried over; a mesh too, so that the port refuses a model
    axis."""
    return dict(
        code=pipe.code,
        rounds=int(pipe.rounds),
        noise_model=pipe.noise_model,
        data_prior=float(pipe.data_prior),
        meas_prior=float(pipe.meas_prior),
        shots_per_device=int(pipe.shots_per_device),
        max_iter=int(pipe.max_iter),
        bp_method=str(pipe.bp_method),
        ms_scaling_factor=float(pipe.ms_scaling_factor),
        early_stop=bool(pipe.early_stop),
        bp_backend=_BACKENDS[pipe.bp_backend],
        osd_fallback_cap=int(pipe.osd_fallback_cap),
        osd_options=None if pipe.osd_options is None else dict(pipe.osd_options),
        use_x_logicals=bool(pipe.use_x_logicals),
        mode=str(pipe.mode),
        mesh=pipe.mesh,
        msg_dtype=str(pipe.msg_dtype),
        tier1_iters=int(pipe.tier1_iters),
        tier2_cap=None if pipe.tier2_cap is None else int(pipe.tier2_cap),
    )


def _matrix_from_schedule(sched) -> sparse.csr_matrix:
    """The (permuted) check matrix a JAX ``BSRSchedule`` encodes: routing
    tile t of (var tile vt, edge tile et) maps edge row et*128+p, i.e. slot
    row // c_pad of check row % c_pad, to variable vt*128 + idx[t, p]."""
    idx = np.asarray(sched.idx)
    rows, cols = [], []
    for vt, pairs in enumerate(sched.sched_m):
        for et, t in pairs:
            p = np.nonzero(idx[t] >= 0)[0]
            rows.append((et * 128 + p) % sched.c_pad)
            cols.append(vt * 128 + idx[t, p])
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return sparse.csr_matrix((np.ones(rows.size, np.uint8), (rows, cols)),
                             shape=(sched.num_checks, sched.num_vars))


def bp_decoder_from_jax(dec, device: DeviceLike = "cuda"):
    """A JAX ``BPDecoder``, ``Int8BPDecoder`` or ``BSRBPDecoder`` (either
    ``msg_dtype``) -> the port's decoder with the same Tanner graph, priors
    (LLRs; int8: quanta and delta), method, iteration cap, scaling, early
    stop and (BSR) shot block and permutations, so both packages decode with
    identical state.  The BSR decoder's graph is read back from its tile
    schedule, which is built from the permuted check matrix."""
    from .decoders.bp import BPDecoder
    from .decoders.bp_bsr import BSRBPDecoder, BSRLayout
    from .decoders.bp_int8 import Int8BPDecoder

    dev = resolve_device(device)
    common = dict(max_iter=int(dec.max_iter), ms_scaling_factor=float(dec.ms_scaling_factor),
                  early_stop=bool(dec.early_stop))
    if hasattr(dec, "prior_q"):
        return Int8BPDecoder(tanner_tables(dec.tanner, dev), np.asarray(dec.prior_q, np.int32),
                             float(dec.delta), **common)
    common.update(prior_llr=np.asarray(dec.prior_llr, dtype=np.float32), method=str(dec.method))
    sched = getattr(dec, "sched", None)
    if sched is None:
        return BPDecoder(tanner_tables(dec.tanner, dev), **common)
    tanner = TannerELL.from_check_matrix(_matrix_from_schedule(sched))
    out = BSRBPDecoder(BSRLayout.from_tanner(tanner, dev), shot_block=int(dec.shot_block),
                       check_perm=dec.check_perm, inv_var_perm=dec.inv_var_perm,
                       msg_dtype=str(dec.msg_dtype), prior_quanta=int(dec.prior_quanta), **common)
    if out.msg_dtype == "int8":  # quantized from the same LLRs: the same quanta and delta
        assert out._delta == dec._delta and np.array_equal(out._prior_q.cpu().numpy(),
                                                           dec._prior_q)
    return out


def sharded_bsr_decoder_from_jax(dec, device: DeviceLike = "cuda"):
    """A JAX ``ShardedBSRDecoder`` -> the port's emulated one (``mesh=None``)
    with the same check matrix (read back from the per-shard tables), shard
    count, prior LLRs, method, scaling and iteration budget."""
    from .decoders.bp_bsr_shard import ShardedBSR, ShardedBSRDecoder

    sb = dec.sharded
    chk_vars = np.asarray(sb.chk_vars).reshape(-1, sb.dc)[: sb.num_checks]
    chk_mask = np.asarray(sb.chk_mask).reshape(-1, sb.dc)[: sb.num_checks]
    rows = np.nonzero(chk_mask)[0]
    H = sparse.csr_matrix((np.ones(rows.size, np.uint8), (rows, chk_vars[chk_mask])),
                          shape=(sb.num_checks, sb.num_vars))
    return ShardedBSRDecoder(ShardedBSR.from_check_matrix(H, sb.num_shards),
                             np.asarray(dec.prior_llr, np.float32), None, str(dec.method),
                             int(dec.max_iter), float(dec.ms_scaling_factor),
                             resolve_device(device))
