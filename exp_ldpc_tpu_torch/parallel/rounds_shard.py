"""Rounds-axis (sequence-parallel) sharded spacetime BP with a 1-D halo
exchange.

Counterpart of ``exp_ldpc_tpu/parallel/rounds_shard.py``.  The spacetime
check matrix is (rounds+1) copies of the base H on the diagonal, and
adjacent round blocks couple only through degree-2 measurement-error
columns: a 1-D halo pattern.  The round blocks are split over the mesh's
model group (:mod:`.mesh`) and the shots over its data group; each
flooding iteration sends exactly two boundary rows of shape (r, S_local)
to the neighbouring ranks of the model group:

  * before the check update, the ``v2c`` message of the last local
    measurement variable goes to the next rank, whose first check block
    reads it in its "previous round" slot;
  * after it, the ``c2v`` message of the first local check block's
    "previous round" slot goes to the previous rank, whose last
    measurement variable reads it.

The math is the fixed-iteration structured decode of
:func:`..decoders.spacetime_bp.stbp_core` (``early_stop=False``, f32
messages), with the same operations in the same order per round block, so
a min-sum decode equals the unsharded one bit for bit; sum-product can
differ in the last bit where PyTorch's vectorised ``log``/``tanh`` take
another path for another tensor size.  The JAX module computes this
outside any Pallas kernel, and so does the port: plain PyTorch on each
rank's device, no kernel of its own.

Round blocks pad to a multiple of the model group's size: padded blocks
carry zero syndromes and +BIG priors, and padded measurement rows are held
at the neutral +BIG every iteration, so no padding reaches a real message.

Point-to-point transport: NCCL sends CUDA tensors as they are; gloo's
``send``/``recv`` take CPU tensors only, so under gloo (several ranks
sharing one card, or the CPU) the halo rows of a CUDA decode, and the
final gathers of the posteriors, are staged through the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from scipy import sparse

from ..convert import TannerTables, tanner_tables
from ..decoders.bp import (BIG, alpha_at, channel_priors, check_parity, check_update_cm,
                           normalize_method, priors_to_llr)
from ..decoders.tanner import TannerELL
from ..utils.device import DeviceLike, resolve_device
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, all_gather_cols, all_reduce_sum

__all__ = ["RoundsShardedSpacetimeBP"]


class _Halo:
    """Shifts (r, S) rows to the next or the previous rank of this rank's
    model group (global ranks rank +- 1: the model axis is the fastest).
    A rank with no neighbour on that side receives nothing (None)."""

    def __init__(self, mesh: Optional[Mesh]):
        self.D = 1 if mesh is None else mesh.shape[MODEL_AXIS]
        self.m = 0 if mesh is None else mesh.model_index
        self.rank = 0 if mesh is None else mesh.rank
        self.stage = self.D > 1 and dist.get_backend() == "gloo"

    def shift(self, t: torch.Tensor, forward: bool) -> Optional[torch.Tensor]:
        """Send ``t`` one rank forward (to m + 1) or back (to m - 1);
        return what the rank on the other side sent."""
        if self.D == 1:
            return None
        step = 1 if forward else -1
        dst_ok = 0 <= self.m + step < self.D
        src_ok = 0 <= self.m - step < self.D
        send = t.contiguous().cpu() if self.stage else t.contiguous()
        recv = torch.empty_like(send) if src_ok else None
        ops = []
        if dst_ok:
            ops.append(dist.P2POp(dist.isend, send, self.rank + step))
        if src_ok:
            ops.append(dist.P2POp(dist.irecv, recv, self.rank - step))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return None if recv is None else recv.to(t.device)


def _local_decode(t: TannerTables, synd, data_llr, meas_llr, valid_m, halo: _Halo,
                  model_group, method: str, max_iter: int, msf: float):
    """One rank's K round blocks of S shots: synd (K, r, S) uint8, data_llr
    (K, n), meas_llr (K, r), valid_m (K, 1, 1) bool (row b holds
    measurement variable m_b of the global block index) -> (posterior_d
    (K, n, S), posterior_m (K, r, S), conv (S,) over every block of the
    model group)."""
    K, r, S = synd.shape
    n, Dc, Dv = t.num_vars, t.max_check_degree, t.max_var_degree
    dev = synd.device
    synd_sign = (1.0 - 2.0 * synd.to(torch.float32)).reshape(K * r, S)
    edge_prior = torch.where(t.chk_mask[None], data_llr[:, t.chk_vars], BIG)     # (K, r, Dc)
    v2c_data = edge_prior[..., None].expand(K, r, Dc, S).contiguous()
    m0 = torch.where(valid_m, meas_llr[..., None], BIG).expand(K, r, S).contiguous()
    v2c_mlo, v2c_mhi = m0, m0.clone()
    big_row = torch.full((r, S), BIG, device=dev)
    zero_row = torch.zeros((K, 1, S), device=dev)
    big_rows = torch.full((K, 1, S), BIG, device=dev)
    pd = data_llr[:, :, None].expand(K, n, S)
    pm = m0
    for it in range(max_iter):
        # halo 1: the previous rank's last measurement row feeds the first
        # local check block's "previous round" slot (+BIG at global block 0)
        prev_mhi = halo.shift(v2c_mhi[-1], forward=True)
        prev_mhi = big_row if prev_mhi is None else prev_mhi
        slot_prev = torch.cat([prev_mhi[None], v2c_mhi[:-1]])      # m_{b-1} -> block b
        v2c_ext = torch.cat([v2c_data, slot_prev[:, :, None], v2c_mlo[:, :, None]], dim=2)
        c2v_ext = check_update_cm(v2c_ext.reshape(K * r, Dc + 2, S), synd_sign, method,
                                  alpha_at(it, msf)).reshape(K, r, Dc + 2, S)
        c2v_data = c2v_ext[:, :, :Dc]
        # data variables: the base code's gather, summed in edge order
        flat = torch.cat([c2v_data.reshape(K, r * Dc, S), zero_row], dim=1)
        c2v_vm = flat[:, t.vm_from_cm]                                 # (K, n, Dv, S)
        totals = c2v_vm[:, :, 0]
        for j in range(1, Dv):
            totals = totals + c2v_vm[:, :, j]
        pd = data_llr[:, :, None] + totals
        flat_vm = torch.cat([(pd[:, :, None] - c2v_vm).reshape(K, n * Dv, S), big_rows], dim=1)
        v2c_data = flat_vm[:, t.cm_from_vm]
        # halo 2: the next rank's first check block's "previous round" c2v
        # feeds the last local measurement variable
        next_c2v = halo.shift(c2v_ext[0, :, Dc], forward=False)
        next_c2v = torch.zeros_like(big_row) if next_c2v is None else next_c2v
        c2m_lo = c2v_ext[:, :, Dc + 1]                                 # from block b
        c2m_hi = torch.cat([c2v_ext[1:, :, Dc], next_c2v[None]])       # from block b + 1
        pm = torch.where(valid_m, meas_llr[:, :, None] + c2m_lo + c2m_hi, BIG)
        v2c_mlo = torch.where(valid_m, pm - c2m_lo, BIG)
        v2c_mhi = torch.where(valid_m, pm - c2m_hi, BIG)
    # spacetime parity of the estimate against the syndromes: the local
    # blocks, with the previous rank's last measurement bits; one sum over
    # the model group at the end
    hard_m = (pm <= 0).to(torch.int32)
    prev_m = halo.shift(hard_m[-1], forward=True)
    prev_m = torch.zeros_like(hard_m[-1]) if prev_m is None else prev_m
    par = (check_parity(pd <= 0, t) + torch.cat([prev_m[None], hard_m[:-1]]) + hard_m) % 2
    bad = (par != synd.to(torch.int32)).sum(dim=(0, 1), dtype=torch.int64)
    return pd, pm, all_reduce_sum(bad, model_group) == 0


@dataclass(eq=False)
class RoundsShardedSpacetimeBP:
    """Fixed-iteration spacetime BP with round blocks sharded over the
    mesh's model axis and shots over its data axis.

    Same inputs and outputs as :class:`..decoders.spacetime_bp.
    SpacetimeBPDecoder` with ``early_stop=False``: ``decode_batch`` takes
    numpy (S, (R+1)·r) syndromes in ``SpacetimeCode`` row order and returns
    numpy (hard (S, Vst), posterior (S, Vst), converged (S,), iters (S,)),
    the whole batch on every rank (every rank passes the same syndromes).
    ``mesh=None`` is one process holding every block on ``device``."""

    tables: TannerTables
    num_rounds: int
    prior_llr: np.ndarray   # (B*n + R*r,) spacetime column order
    mesh: Optional[Mesh] = None
    method: str = "ms"
    max_iter: int = 32
    ms_scaling_factor: float = 0.0

    def __post_init__(self):
        self.method = normalize_method(self.method)
        D = 1 if self.mesh is None else self.mesh.shape[MODEL_AXIS]
        B = self.num_rounds + 1
        self._B_pad = -(-B // D) * D
        self._halo = _Halo(self.mesh)
        if self.mesh is not None and self.mesh.device != self.tables.device:
            raise ValueError("the tables must lie on the mesh's device")

    @property
    def device(self) -> torch.device:
        return self.tables.device

    @classmethod
    def from_check_matrix(cls, H, num_rounds: int, mesh: Optional[Mesh] = None, *,
                          error_rate: Optional[float] = None,
                          channel_probs: Optional[np.ndarray] = None, max_iter: int = 32,
                          bp_method: str = "ms", ms_scaling_factor: float = 0.0,
                          device: DeviceLike = "cuda") -> "RoundsShardedSpacetimeBP":
        """H is the base check matrix (r, n); priors are per spacetime
        column, or a scalar.  The tables go to the mesh's device (else
        ``device``)."""
        tanner = TannerELL.from_check_matrix(sparse.csr_matrix(H))
        Vst = (num_rounds + 1) * tanner.num_vars + num_rounds * tanner.num_checks
        priors = channel_priors(Vst, error_rate, channel_probs)
        dev = mesh.device if mesh is not None else resolve_device(device)
        return cls(tanner_tables(tanner, dev), int(num_rounds), priors_to_llr(priors), mesh,
                   bp_method, int(max_iter), float(ms_scaling_factor))

    def _local_blocks(self) -> slice:
        D = 1 if self.mesh is None else self.mesh.shape[MODEL_AXIS]
        K = self._B_pad // D
        m = 0 if self.mesh is None else self.mesh.model_index
        return slice(m * K, (m + 1) * K)

    def decode_batch(self, syndromes: np.ndarray):
        t = self.tables
        r, n = t.num_checks, t.num_vars
        R, B, Bp = self.num_rounds, self.num_rounds + 1, self._B_pad
        syndromes = np.asarray(syndromes, dtype=np.uint8)
        S = syndromes.shape[0]
        n_data = 1 if self.mesh is None else self.mesh.shape[DATA_AXIS]
        if S % n_data != 0:
            raise ValueError(f"shot count {S} not divisible by data axis {n_data}")
        if syndromes.shape[1] != B * r:
            raise ValueError(f"syndromes have {syndromes.shape[1]} columns, expected {B * r}")
        S_loc = S // n_data
        d = 0 if self.mesh is None else self.mesh.data_index
        blocks = self._local_blocks()
        # the padded arrays of the whole batch, then this rank's blocks and shots
        synd = np.zeros((Bp, r, S), np.uint8)
        synd[:B] = syndromes.T.reshape(B, r, S)
        data_llr = np.full((Bp, n), BIG, np.float32)
        data_llr[:B] = self.prior_llr[: B * n].reshape(B, n)
        meas_llr = np.full((Bp, r), BIG, np.float32)
        meas_llr[:R] = self.prior_llr[B * n:].reshape(R, r)
        valid_m = (np.arange(Bp) < R)[:, None, None]
        dev = self.device
        pd, pm, conv = _local_decode(
            t, torch.as_tensor(synd[blocks, :, d * S_loc:(d + 1) * S_loc].copy()).to(dev),
            torch.as_tensor(data_llr[blocks]).to(dev), torch.as_tensor(meas_llr[blocks]).to(dev),
            torch.as_tensor(valid_m[blocks]).to(dev), self._halo,
            None if self.mesh is None else self.mesh.model_group, self.method,
            int(self.max_iter), float(self.ms_scaling_factor))
        # the whole batch on every rank: blocks over the model group, shots
        # over the data group (through the host under gloo)
        group_m = None if self.mesh is None else self.mesh.model_group
        group_d = None if self.mesh is None else self.mesh.data_group
        if self.mesh is not None and dist.get_backend() == "gloo":
            pd, pm, conv = pd.cpu(), pm.cpu(), conv.cpu()
        pd = all_gather_cols(_gather_blocks(pd, group_m), group_d)
        pm = all_gather_cols(_gather_blocks(pm, group_m), group_d)
        conv = all_gather_cols(conv, group_d)
        posterior = torch.cat([pd[:B].reshape(B * n, S), pm[:R].reshape(R * r, S)]).cpu().numpy()
        hard = (posterior <= 0).astype(np.uint8)
        iters = np.full((S,), self.max_iter, np.int32)
        return hard.T, posterior.T, conv.cpu().numpy(), iters


def _gather_blocks(x: torch.Tensor, group) -> torch.Tensor:
    """(K, ..., S) blocks of the group's ranks, in rank order, concatenated
    along the block axis."""
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)
