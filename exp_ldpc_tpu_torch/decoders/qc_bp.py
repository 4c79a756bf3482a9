"""Quasi-cyclic structured BP: circulant-block routing as cyclic rolls.

Counterpart of ``exp_ldpc_tpu/decoders/qc_bp.py``.  The check matrices of
bivariate bicycle codes, quasi-cyclic lifted products and cyclic lifted
products are grids of circulant blocks, each a sum of shifted identities,
so routing a message between a check and a variable is a cyclic shift.
:func:`qc_bp_core` keeps one ``(*dims, S)`` message plane per circulant
MONOMIAL and runs the flooding update of :func:`.bp.bp_core` (the same
:func:`.bp.check_update_cm`, the same per-shot freezing early stop) with
``torch.roll`` over the factor axes as its only data movement.  It reaches
no hand-written kernel: the JAX version is plain XLA too.

Block structure is DETECTED from the matrix
(:meth:`QCStructure.from_check_matrix`): the caller gives the cyclic
factor sizes ``dims`` (``(31,)`` for one circulant factor, ``(12, 6)`` for
a bivariate Z_12 x Z_6 code) and every block is validated to be an exact
sum of shifted identities; other matrices raise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
from scipy import sparse

from ..utils.device import DeviceLike, resolve_device
from .bp import (BIG, DecoderBase, alpha_at, channel_priors, check_update_cm,
                 normalize_method, priors_to_llr)

__all__ = ["QCStructure", "qc_bp_core", "QCBPDecoder"]


@dataclass(frozen=True, eq=False)
class QCStructure:
    """Circulant-block structure of a check matrix.

    ``monomials[k] = (check_block, var_block, shifts)`` means block
    (check_block, var_block) contains the monomial with per-factor shifts
    ``shifts``: check row r (multi-index over ``dims``) touches var column
    r + shifts (componentwise mod dims)."""

    dims: Tuple[int, ...]
    num_check_blocks: int
    num_var_blocks: int
    monomials: Tuple[Tuple[int, int, Tuple[int, ...]], ...]

    @property
    def block_size(self) -> int:
        return int(np.prod(self.dims))

    @property
    def num_checks(self) -> int:
        return self.num_check_blocks * self.block_size

    @property
    def num_vars(self) -> int:
        return self.num_var_blocks * self.block_size

    @classmethod
    def from_check_matrix(cls, H, dims) -> "QCStructure":
        dims = tuple(int(d) for d in dims)
        L = int(np.prod(dims))
        H = sparse.csr_matrix(H)
        Hd = (H.toarray() % 2).astype(np.uint8)
        r, n = Hd.shape
        if r % L or n % L:
            raise ValueError(
                f"shape {Hd.shape} not divisible by block size {L} (dims={dims})"
            )
        mb, nb = r // L, n // L
        monomials = []
        for i in range(mb):
            for j in range(nb):
                blk = Hd[i * L:(i + 1) * L, j * L:(j + 1) * L]
                cols = np.nonzero(blk[0])[0]
                expect = np.zeros((L, L), np.uint8)
                shifts = []
                for c in cols:
                    s = np.unravel_index(int(c), dims)
                    shifts.append(tuple(int(x) for x in s))
                    # monomial: row multi-index r -> column r + s (mod dims)
                    m = np.eye(dims[0], dtype=np.uint8)
                    m = np.roll(m, s[0], axis=1)
                    for ax in range(1, len(dims)):
                        e = np.roll(np.eye(dims[ax], dtype=np.uint8), s[ax], axis=1)
                        m = np.kron(m, e)
                    expect ^= m
                if not np.array_equal(blk, expect):
                    raise ValueError(
                        f"block ({i},{j}) is not a sum of shifted identities "
                        f"over dims={dims}"
                    )
                monomials += [(i, j, s) for s in shifts]
        return cls(
            dims=dims,
            num_check_blocks=mb,
            num_var_blocks=nb,
            monomials=tuple(monomials),
        )


def _roll(x: torch.Tensor, shifts, sign: int) -> torch.Tensor:
    """Roll the leading factor axes of (*dims, S) by sign*shifts."""
    return torch.roll(x, tuple(sign * s for s in shifts), tuple(range(len(shifts))))


def qc_bp_core(struct: QCStructure, prior_llr: torch.Tensor, syndromes: torch.Tensor,
               method: str, max_iter: int, ms_scaling_factor: float, early_stop: bool = True):
    """syndromes (C, S) 0/1 -> (hard (V, S) uint8, posterior (V, S) f32,
    converged (S,) bool, iters (S,) int32) on the tensors' device: the
    :func:`.bp.bp_core` contract."""
    method = normalize_method(method)
    dims = struct.dims
    L = struct.block_size
    mb, nb = struct.num_check_blocks, struct.num_var_blocks
    mons = struct.monomials
    by_check = [[k for k, m in enumerate(mons) if m[0] == i] for i in range(mb)]
    by_var = [[k for k, m in enumerate(mons) if m[1] == j] for j in range(nb)]
    Dc = max(len(ks) for ks in by_check)
    nd = len(dims)

    S = syndromes.shape[1]
    dev = syndromes.device
    synd_sign = 1.0 - 2.0 * syndromes.to(torch.float32)                 # (C, S)
    synd_i32 = syndromes.to(torch.int32).reshape((mb,) + dims + (S,))
    prior_b = prior_llr.to(device=dev, dtype=torch.float32).reshape((nb,) + dims)

    # one message plane per monomial, CHECK-major: plane_k[r] lives on edge
    # (check (i, r), var (j, r + s)).  init = prior at the edge's variable.
    v2c0 = [_roll(prior_b[m[1]], m[2], -1)[..., None].expand(dims + (S,)) for m in mons]
    pad = torch.full(dims + (S,), BIG, dtype=torch.float32, device=dev)

    def step(it, v2c):
        # check update: group planes per check block, pad to Dc, and reuse
        # the generic check update on (mb*L, Dc, S)
        stacked = torch.stack([
            torch.stack([v2c[k] for k in ks] + [pad] * (Dc - len(ks))) for ks in by_check])
        cm = torch.movedim(stacked, 1, -2).reshape(mb * L, Dc, S)
        c2v_cm = check_update_cm(cm, synd_sign, method, alpha_at(it, ms_scaling_factor))
        c2v_st = torch.movedim(c2v_cm.reshape((mb,) + dims + (Dc, S)), -2, 1)
        c2v = [None] * len(mons)
        for i, ks in enumerate(by_check):
            for slot, k in enumerate(ks):
                c2v[k] = c2v_st[i, slot]
        # variable update: roll each plane into var alignment and sum, the
        # prior first and the monomials in order
        posts = []
        for j, ks in enumerate(by_var):
            tot = prior_b[j][..., None].expand(dims + (S,))
            for k in ks:
                tot = tot + _roll(c2v[k], mons[k][2], +1)
            posts.append(tot)
        posterior = torch.stack(posts)                                  # (nb, *dims, S)
        v2c_new = [_roll(posterior[m[1]], m[2], -1) - c2v[k] for k, m in enumerate(mons)]
        return v2c_new, posterior

    def syndrome_ok(posterior):
        hard_b = (posterior <= 0).to(torch.int32)
        par = torch.zeros((mb,) + dims + (S,), dtype=torch.int32, device=dev)
        for m in mons:
            par[m[0]] += _roll(hard_b[m[1]], m[2], -1)
        return (par % 2 == synd_i32).reshape(mb * L, S).all(dim=0)

    def flatten(posterior):
        post = posterior.reshape(nb * L, S)
        return (post <= 0).to(torch.uint8), post

    posterior = prior_b[..., None].expand((nb,) + dims + (S,))
    v2c = v2c0
    if not early_stop:
        for it in range(max_iter):
            v2c, posterior = step(it, v2c)
        hard, post = flatten(posterior)
        return (hard, post.contiguous(), syndrome_ok(posterior),
                torch.full((S,), max_iter, dtype=torch.int32, device=dev))

    hard, post = flatten(posterior)
    post = post.clone()
    conv = torch.zeros(S, dtype=torch.bool, device=dev)
    iters = torch.zeros(S, dtype=torch.int32, device=dev)
    it = 0
    while it < max_iter and not bool(conv.all()):
        v2c, posterior = step(it, v2c)
        hard_new, post_new = flatten(posterior)
        ok = syndrome_ok(posterior)
        # freeze each shot's outputs at its first convergence
        hard = torch.where(conv[None], hard, hard_new)
        post = torch.where(conv[None], post, post_new)
        iters = torch.where(conv, iters, it + 1)
        conv = conv | ok
        it += 1
    return hard, post, conv, iters


@dataclass
class QCBPDecoder(DecoderBase):
    """Batched BP for quasi-cyclic codes with the :class:`.bp.BPDecoder`
    contract.

    ``check_perm``/``var_perm`` (new -> old) bring a matrix that is
    block-circulant only up to row/column order into QC order (e.g. abelian
    lifted products, ``codes/lifted.py::_abelian_qc_layout``); syndromes
    are permuted in and all outputs return in the ORIGINAL column order."""

    struct: QCStructure
    prior_llr: np.ndarray     # in the permuted column order
    method: str = "ps"
    max_iter: int = 0
    ms_scaling_factor: float = 0.0
    early_stop: bool = True
    check_perm: Optional[np.ndarray] = None
    inv_var_perm: Optional[np.ndarray] = None  # old -> new
    device: DeviceLike = "cuda"

    def __post_init__(self):
        self.method = normalize_method(self.method)
        if self.max_iter <= 0:
            self.max_iter = self.struct.num_vars
        self.device = dev = resolve_device(self.device)
        self._prior = torch.as_tensor(np.asarray(self.prior_llr, dtype=np.float32)).to(dev)
        self._check_perm = None if self.check_perm is None else torch.as_tensor(
            np.asarray(self.check_perm, dtype=np.int64)).to(dev)
        self._inv_var_perm = None if self.inv_var_perm is None else torch.as_tensor(
            np.asarray(self.inv_var_perm, dtype=np.int64)).to(dev)

    @classmethod
    def from_check_matrix(cls, H, dims, *, error_rate: Optional[float] = None,
                          channel_probs: Optional[np.ndarray] = None, max_iter: int = 0,
                          bp_method: str = "ps", ms_scaling_factor: float = 0.0,
                          early_stop: bool = True, check_perm: Optional[np.ndarray] = None,
                          var_perm: Optional[np.ndarray] = None, device: DeviceLike = "cuda",
                          **_ignored) -> "QCBPDecoder":
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
        struct = QCStructure.from_check_matrix(H, dims)
        prior = channel_priors(struct.num_vars, error_rate, channel_probs)
        if var_perm is not None:
            prior = prior[var_perm]
        return cls(struct, priors_to_llr(prior), bp_method, max_iter, float(ms_scaling_factor),
                   early_stop, check_perm, inv_var_perm, device)

    def decode_tensors(self, syndromes: torch.Tensor):
        """(C, S) device syndromes in the original check order -> (hard,
        posterior, conv, iters) with rows in the original column order."""
        if self._check_perm is not None:
            syndromes = syndromes[self._check_perm]
        hard, post, conv, iters = qc_bp_core(
            self.struct, self._prior, syndromes, self.method, self.max_iter,
            self.ms_scaling_factor, self.early_stop)
        if self._inv_var_perm is not None:
            hard, post = hard[self._inv_var_perm], post[self._inv_var_perm]
        return hard, post, conv, iters
