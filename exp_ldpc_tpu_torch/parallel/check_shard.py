"""Check-partition (model-parallel) flat BP in plain PyTorch.

Counterpart of ``exp_ldpc_tpu/parallel/check_shard.py``: the f32 gather
formulation of :func:`..decoders.bp.bp_core` with the checks split over
the mesh's model axis.  Each rank owns ``C_loc = ceil(C / D)`` check rows
and the messages of their edges, check-major (C_loc, Dc, S); per
iteration it sums its c2v messages into (V, S) partial variable totals,
which one ``all_reduce`` over the model group turns into the posterior.
Shots shard over the data axis at the same time.  No kernel: this is the
plain formulation, which the JAX package ran on XLA.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from scipy import sparse

from ..decoders.bp import BIG, alpha_at, channel_priors, check_update_cm, normalize_method, \
    priors_to_llr
from ..utils.device import DeviceLike, resolve_device
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, all_gather_cols, all_reduce_sum

__all__ = ["ShardedTanner", "ShardedBPDecoder"]


@dataclass(frozen=True, eq=False)
class ShardedTanner:
    """Per-shard index arrays (leading shard axis D):

      chk_vars   (D, C_loc, Dc) int32, global variable of each local slot
      chk_mask   (D, C_loc, Dc) bool
      vm_local   (D, V, Dv) int32, per variable the indices of its locally
                 incident edges into the flat check-major (C_loc*Dc) array,
                 pad = C_loc*Dc (a one-past-the-end zero row)
    """

    num_checks: int
    num_vars: int
    num_shards: int
    checks_per_shard: int
    chk_vars: np.ndarray
    chk_mask: np.ndarray
    vm_local: np.ndarray

    @property
    def max_check_degree(self) -> int:
        return self.chk_vars.shape[2]

    @classmethod
    def from_check_matrix(cls, H, num_shards: int) -> "ShardedTanner":
        H = sparse.csr_matrix(H).copy()
        H.data = H.data % 2
        H.eliminate_zeros()
        H.sort_indices()
        C, V = H.shape
        D = int(num_shards)
        C_loc = -(-C // D)
        deg = np.diff(H.indptr)
        Dc = int(deg.max(initial=1))
        c = np.repeat(np.arange(C), deg)
        slot = np.arange(H.nnz) - H.indptr[c]
        d, cl = np.divmod(c, C_loc)
        v = H.indices.astype(np.int64)
        chk_vars = np.zeros((D, C_loc, Dc), np.int32)
        chk_mask = np.zeros((D, C_loc, Dc), bool)
        chk_vars[d, cl, slot] = v
        chk_mask[d, cl, slot] = True
        # edges in check order: each variable's local edges keep that order
        key = d * V + v
        order = np.argsort(key, kind="stable")
        k_o = key[order]
        first = np.r_[0, np.nonzero(np.diff(k_o))[0] + 1] if k_o.size else np.zeros(0, int)
        pos = np.arange(k_o.size) - np.repeat(first, np.diff(np.r_[first, k_o.size]))
        Dv = int(H.getnnz(axis=0).max(initial=1))
        vm_local = np.full((D, V, Dv), C_loc * Dc, np.int32)
        vm_local[d[order], v[order], pos] = (cl * Dc + slot)[order]
        return cls(C, V, D, C_loc, chk_vars, chk_mask, vm_local)


@dataclass(eq=False)
class ShardedBPDecoder:
    """Batched flat BP with the checks split over the model axis and the
    shots over the data axis.

    ``decode_batch`` takes (S, C) syndromes and returns numpy (hard (S, V),
    posterior (S, V), conv (S,)), the JAX contract.  ``mesh=None`` is one
    process and one device (one shard).  With ``early_stop`` each shot
    freezes at its first convergence and a rank stops once all its shots
    have converged (the model group agrees, since the parity counts are
    all-reduced); otherwise every shot runs ``max_iter`` iterations.  Every
    rank must call ``decode_batch`` with the same syndromes."""

    tanner: ShardedTanner
    prior_llr: np.ndarray
    mesh: Optional[Mesh] = None
    method: str = "ps"
    max_iter: int = 0
    ms_scaling_factor: float = 0.0
    early_stop: bool = True
    device: DeviceLike = "cuda"

    def __post_init__(self):
        self.method = normalize_method(self.method)
        if self.max_iter <= 0:
            self.max_iter = self.tanner.num_vars
        model = 1 if self.mesh is None else self.mesh.shape[MODEL_AXIS]
        if model != self.tanner.num_shards:
            raise ValueError(f"tanner built for {self.tanner.num_shards} shards but mesh model "
                             f"axis is {model}")
        if self.mesh is not None:
            self.device = self.mesh.device
        dev = self.device = resolve_device(self.device)
        m = 0 if self.mesh is None else self.mesh.model_index
        t = self.tanner

        def tt(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a)).to(device=dev, dtype=dtype)

        self._chk_vars = tt(t.chk_vars[m], torch.int64)
        self._mask = tt(t.chk_mask[m], torch.bool)
        self._vm = tt(t.vm_local[m], torch.int64)
        self._prior = tt(np.asarray(self.prior_llr, np.float32), torch.float32)

    @classmethod
    def from_check_matrix(cls, H, mesh: Optional[Mesh] = None, *,
                          error_rate: Optional[float] = None,
                          channel_probs: Optional[np.ndarray] = None, max_iter: int = 0,
                          bp_method: str = "ps", ms_scaling_factor: float = 0.0,
                          early_stop: bool = True, device: DeviceLike = "cuda") -> "ShardedBPDecoder":
        D = 1 if mesh is None else mesh.shape[MODEL_AXIS]
        tanner = ShardedTanner.from_check_matrix(H, D)
        prior = channel_priors(tanner.num_vars, error_rate, channel_probs)
        return cls(tanner, priors_to_llr(prior), mesh, bp_method, max_iter,
                   float(ms_scaling_factor), early_stop, device)

    def decode_tensors(self, syndromes: torch.Tensor):
        """(C_loc, S) syndromes of this rank's checks and shots -> (hard (V,
        S) uint8, posterior (V, S) f32, conv (S,) bool)."""
        t = self.tanner
        C_loc, Dc, V = t.checks_per_shard, t.max_check_degree, t.num_vars
        S = syndromes.shape[1]
        dev = self.device
        group = None if self.mesh is None else self.mesh.model_group
        mask3 = self._mask[:, :, None]
        synd_sign = 1.0 - 2.0 * syndromes.to(torch.float32)
        prior = self._prior
        zero_row = torch.zeros((1, S), device=dev)

        def syndrome_ok(hard):
            bits = torch.where(mask3, hard[self._chk_vars], 0).to(torch.int32)
            bad = ((bits.sum(dim=1) % 2) != syndromes.to(torch.int32)).to(torch.int32).sum(0)
            return all_reduce_sum(bad, group) == 0

        def step(it, v2c):
            c2v = check_update_cm(v2c, synd_sign, self.method,
                                  alpha_at(it, self.ms_scaling_factor))
            g = torch.cat([c2v.reshape(C_loc * Dc, S), zero_row])[self._vm]   # (V, Dv, S)
            part = g[:, 0]
            for j in range(1, g.shape[1]):
                part = part + g[:, j]
            posterior = prior[:, None] + all_reduce_sum(part.contiguous(), group)
            return torch.where(mask3, posterior[self._chk_vars] - c2v, BIG), posterior

        edge_prior = torch.where(self._mask, prior[self._chk_vars], BIG)
        v2c = edge_prior[:, :, None].expand(C_loc, Dc, S).contiguous()
        post = prior[:, None].expand(V, S).contiguous()
        if not self.early_stop:
            for it in range(self.max_iter):
                v2c, post = step(it, v2c)
            hard = (post <= 0).to(torch.uint8)
            return hard, post, syndrome_ok(hard)
        hard = torch.zeros((V, S), dtype=torch.uint8, device=dev)
        conv = torch.zeros(S, dtype=torch.bool, device=dev)
        it = 0
        while it < self.max_iter and not bool(conv.all()):
            v2c, posterior = step(it, v2c)
            hard_new = (posterior <= 0).to(torch.uint8)
            ok = syndrome_ok(hard_new)
            hard = torch.where(conv[None], hard, hard_new)
            post = torch.where(conv[None], post, posterior)
            conv = conv | ok
            it += 1
        return hard, post, conv

    def decode_batch(self, syndromes: np.ndarray):
        t = self.tanner
        syndromes = np.asarray(syndromes, dtype=np.uint8)
        S, C = syndromes.shape
        if C != t.num_checks:
            raise ValueError(f"syndromes have {C} columns, expected {t.num_checks}")
        n_data = 1 if self.mesh is None else self.mesh.shape[DATA_AXIS]
        d, m = (0, 0) if self.mesh is None else self.mesh.coords
        S_loc = -(-S // n_data)
        C_loc = t.checks_per_shard
        synd = np.zeros((t.num_shards * C_loc, S_loc), np.uint8)
        mine = syndromes[d * S_loc: (d + 1) * S_loc]
        synd[:C, : mine.shape[0]] = mine.T
        hard, post, conv = self.decode_tensors(
            torch.as_tensor(synd[m * C_loc: (m + 1) * C_loc]).to(self.device))
        if self.mesh is not None:
            group = self.mesh.data_group
            hard = all_gather_cols(hard, group)
            post = all_gather_cols(post, group)
            conv = all_gather_cols(conv.to(torch.uint8), group).bool()
        return hard[:, :S].T.cpu().numpy(), post[:, :S].T.cpu().numpy(), conv[:S].cpu().numpy()
