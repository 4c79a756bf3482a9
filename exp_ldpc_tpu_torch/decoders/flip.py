"""Batched flip and small-set-flip decoders in plain PyTorch.

Counterpart of ``exp_ldpc_tpu/decoders/flip.py``:

  * :class:`FlipDecoder` — parallel bit-flip for classical codes: every
    bit for which a strict majority of its checks is unsatisfied flips;
    two dense 0/1 matrix products per iteration.
  * :class:`SmallSetFlipDecoder` — small-set-flip for one CSS sector
    (arXiv:1504.00822): each iteration applies, per shot, the single
    (generator, subset) flip with the best positive (syndrome-weight
    decrease) / |subset| ratio.  The gains of all subsets of all
    generators come from one batched product over a precomputed
    subset -> syndrome-change table; the chosen flip is applied by gathers
    of its qubit and check lists and ``index_add_`` (the JAX module's
    one-hot matrix products).

Ties go to the first maximum (``torch.argmax``, as ``jnp.argmax``), and the
gain ratio is the decrease times the f32 reciprocal of the subset size, as
in JAX; every value is a small exact integer or such a product, so both
decoders equal the JAX ones and the numpy oracles (:func:`flip_decode_numpy`,
:func:`ssf_decode_numpy`, the port's copies of the JAX module's) bit for
bit.  Shots freeze at their first convergence or when no flip helps; the
loop stops when every shot has, with one host read per iteration.  The JAX
module has no Pallas kernel: this is PyTorch on the tables' device.

On a CUDA device :class:`SmallSetFlipDecoder` splits a batch into chunks
whose gain tables (generators x subsets x shots, f32) take at most a
quarter of the card's free memory (:func:`ssf_shot_chunk`); shots decode
independently, so a split changes no output.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from scipy import sparse

from ..utils.device import DeviceLike, resolve_device

__all__ = [
    "FlipDecoder",
    "SmallSetFlipDecoder",
    "flip_core",
    "ssf_core",
    "ssf_shot_chunk",
    "flip_decode_numpy",
    "ssf_decode_numpy",
]

_NEG = np.float32(-1e30)


def _dense01(H) -> np.ndarray:
    H = sparse.csr_matrix(H)
    return (H.toarray() % 2).astype(np.float32)


# --------------------------------------------------------------------------
# parallel bit-flip (classical)
# --------------------------------------------------------------------------


def flip_core(Hd: torch.Tensor, deg: torch.Tensor, syndromes: torch.Tensor, max_iter: int):
    """Hd (C, V) 0/1 f32; deg (V,) f32; syndromes (C, S) 0/1.

    Returns (hard (V, S) uint8, converged (S,) bool, iters (S,) int32)."""
    S = syndromes.shape[1]
    V = Hd.shape[1]
    dev = syndromes.device
    s = syndromes.to(torch.float32)
    e = torch.zeros((V, S), device=dev)
    conv = (s == 0).all(dim=0)
    done = conv.clone()
    iters = torch.zeros(S, dtype=torch.int32, device=dev)
    for it in range(max_iter):
        if bool(done.all()):
            break
        active = ~done
        flip = ((2.0 * (Hd.T @ s) > deg[:, None]) & active[None]).to(torch.float32)
        e = torch.remainder(e + flip, 2.0)
        s = torch.remainder(s + Hd @ flip, 2.0)
        ok = (s == 0).all(dim=0)
        stuck = (flip == 0).all(dim=0) & active   # the majority rule fired nothing
        iters = torch.where(active, it + 1, iters)
        conv = conv | (ok & active)
        done = done | ok | stuck
    return e.to(torch.uint8), conv, iters


@dataclass
class FlipDecoder:
    """Parallel bit-flip decoder for a fixed classical check matrix.

    ``decode_batch`` takes (S, C) syndromes and returns numpy ((S, V) hard
    decisions, (S,) converged-to-zero-syndrome flags, (S,) iterations)."""

    Hd: np.ndarray  # dense 0/1 f32 (C, V)
    max_iter: int = 0
    device: DeviceLike = "cuda"

    def __post_init__(self):
        if self.max_iter <= 0:
            self.max_iter = self.Hd.shape[1]
        self.device = resolve_device(self.device)
        self._Hd = torch.as_tensor(self.Hd).to(self.device)
        self._deg = torch.as_tensor(self.Hd.sum(axis=0)).to(self.device)

    @classmethod
    def from_check_matrix(cls, H, *, max_iter: int = 0,
                          device: DeviceLike = "cuda") -> "FlipDecoder":
        return cls(Hd=_dense01(H), max_iter=max_iter, device=device)

    def decode_batch(self, syndromes: np.ndarray):
        s = torch.as_tensor(np.ascontiguousarray(np.asarray(syndromes, dtype=np.uint8).T))
        hard, conv, iters = flip_core(self._Hd, self._deg, s.to(self.device), self.max_iter)
        return hard.T.cpu().numpy(), conv.cpu().numpy(), iters.cpu().numpy()


def flip_decode_numpy(H, syndromes, max_iter: int = 0):
    """CPU oracle with the identical parallel-majority rule (bit-exact)."""
    Hd = _dense01(H)
    C, V = Hd.shape
    if max_iter <= 0:
        max_iter = V
    deg = Hd.sum(axis=0)
    syndromes = np.asarray(syndromes, dtype=np.uint8)
    S = syndromes.shape[0]
    e = np.zeros((S, V), np.uint8)
    s = syndromes.astype(np.float32).copy()
    conv = np.all(s == 0, axis=1)
    done = conv.copy()
    iters = np.zeros(S, np.int32)
    for it in range(max_iter):
        if done.all():
            break
        unsat = s @ Hd  # (S, V)
        flip = (2.0 * unsat > deg[None, :]) & ~done[:, None]
        e ^= flip.astype(np.uint8)
        s = (s + flip.astype(np.float32) @ Hd.T) % 2
        ok = np.all(s == 0, axis=1)
        stuck = ~flip.any(axis=1) & ~done
        iters[~done] = it + 1
        conv |= ok & ~done
        done |= ok | stuck
    return e, conv, iters


# --------------------------------------------------------------------------
# small-set-flip (CSS)
# --------------------------------------------------------------------------


def _ssf_tables(H, G, max_subset_weight: int):
    """Host precompute of the per-generator subset search tables.

    H (C, V): the syndrome check matrix; G (R, V): opposite-sector stabilizer
    generators whose supports the search flips within.

    Returns (gen_qubits (R, W) int32 pad=V, chk_ids (R, L) int32 pad=C,
    delta (R, K, L) f32 with K=2^W subset syndrome-changes, sizes (K,) f32
    subset cardinalities, Wbits (K, W) f32 subset bit patterns)."""
    Hd = _dense01(H).astype(np.uint8)
    Gd = _dense01(G).astype(np.uint8)
    C, V = Hd.shape
    R = Gd.shape[0]
    supports = [np.nonzero(Gd[r])[0] for r in range(R)]
    W = max((len(s) for s in supports), default=0)
    if W > max_subset_weight:
        raise ValueError(
            f"generator weight {W} exceeds max_subset_weight={max_subset_weight} "
            f"(2^{W} subsets per generator)"
        )
    K = 1 << W
    # local H-checks touched by each generator's support
    locals_ = [np.nonzero(Hd[:, s].any(axis=1))[0] for s in supports]
    L = max((len(c) for c in locals_), default=1)

    gen_qubits = np.full((R, W), V, np.int32)
    chk_ids = np.full((R, L), C, np.int32)
    Hloc = np.zeros((R, L, W), np.uint8)
    for r in range(R):
        q = supports[r]
        c = locals_[r]
        gen_qubits[r, : len(q)] = q
        chk_ids[r, : len(c)] = c
        Hloc[r, : len(c), : len(q)] = Hd[np.ix_(c, q)]

    bits = ((np.arange(K)[:, None] >> np.arange(W)[None, :]) & 1).astype(np.uint8)
    # delta[r, k, l] = parity of H restricted rows over subset k
    delta = np.einsum("kw,rlw->rkl", bits, Hloc) % 2
    sizes = bits.sum(axis=1).astype(np.float32)
    return (
        gen_qubits,
        chk_ids,
        delta.astype(np.float32),
        sizes,
        bits.astype(np.float32),
    )


def _add_rows(x: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """x (N, S) plus, for every shot s and list slot j, ``vals[s, j]`` at row
    ``rows[s, j]``; a row id of N (the tables' pad) adds nothing."""
    N, S = x.shape
    shot = torch.arange(S, device=x.device)[:, None].expand_as(rows)
    out = torch.zeros((N + 1) * S, device=x.device)
    out.index_add_(0, (rows.to(torch.int64) * S + shot).reshape(-1), vals.reshape(-1))
    return x + out[: N * S].view(N, S)


def ssf_core(gen_qubits: torch.Tensor, chk_ids: torch.Tensor, delta: torch.Tensor,
             sizes: torch.Tensor, bits: torch.Tensor, syndromes: torch.Tensor, num_vars: int,
             max_iter: int):
    """syndromes (C, S) 0/1 -> (hard (V, S) uint8, conv (S,) bool, iters (S,) int32).

    Each iteration applies, per shot, the single (generator, subset) flip
    with the best positive (syndrome-weight decrease)/|subset| ratio."""
    C, S = syndromes.shape
    R, K, L = delta.shape
    V = num_vars
    dev = syndromes.device
    inv_sizes = torch.where(sizes > 0, 1.0 / torch.clamp(sizes, min=1.0), float(_NEG))
    s = syndromes.to(torch.float32)
    e = torch.zeros((V, S), device=dev)
    conv = (s == 0).all(dim=0)
    done = conv.clone()
    iters = torch.zeros(S, dtype=torch.int32, device=dev)
    s_pad_row = torch.zeros((1, S), device=dev)
    gq, ci = gen_qubits.to(torch.int64), chk_ids.to(torch.int64)
    for it in range(max_iter):
        if bool(done.all()):
            break
        s_loc = torch.cat([s, s_pad_row])[ci]                         # (R, L, S), pad check -> 0
        # decrease[r, k, s] = sum_l delta[r, k, l] * (2 s_loc[r, l, s] - 1)
        ratio = torch.bmm(delta, 2.0 * s_loc - 1.0).mul_(inv_sizes[None, :, None])
        flat = ratio.view(R * K, S)
        idx = torch.argmax(flat, dim=0)                                # first max
        best = flat.gather(0, idx[None])[0]
        active = (best > 0) & ~done
        del ratio, flat
        gen, sub = idx // K, idx % K
        act = active.to(torch.float32)[:, None]
        # the chosen subset's qubits and its syndrome change on its local checks
        e = torch.remainder(_add_rows(e, gq[gen], bits[sub] * act), 2.0)
        s = torch.remainder(_add_rows(s, ci[gen], delta[gen, sub] * act), 2.0)
        ok = (s == 0).all(dim=0)
        iters = torch.where(active, it + 1, iters)
        conv = conv | (ok & active)
        done = done | ok | ~active
    return e.to(torch.uint8), conv, iters


def ssf_shot_chunk(num_entries: int, shots: int, free_bytes: Optional[int]) -> int:
    """Shots per :func:`ssf_core` call: all of them, or on a card (given its
    free memory) as many as keep the gain table and its product (two f32
    arrays of ``num_entries`` = generators x subsets values per shot) under
    a quarter of the free memory, at least one."""
    if free_bytes is None:
        return max(1, shots)
    return max(1, min(shots, free_bytes // 4 // (2 * 4 * num_entries)))


@dataclass
class SmallSetFlipDecoder:
    """Small-set-flip decoder for one CSS sector.

    ``H`` is the check matrix producing the syndrome (e.g. ``checks.z`` for
    X errors) and ``generators`` the OPPOSITE sector's stabilizer matrix
    (``checks.x``), whose row supports bound the flip subsets.

    ``decode_batch`` takes (S, C) syndromes and returns numpy ((S, V) hard
    decisions, (S,) converged flags, (S,) flips applied)."""

    tables: tuple   # numpy, as _ssf_tables returns them
    num_vars: int
    max_iter: int
    device: DeviceLike = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._tables = tuple(torch.as_tensor(np.ascontiguousarray(t)).to(self.device)
                             for t in self.tables)

    @classmethod
    def from_css(cls, H, generators, *, max_iter: int = 0, max_subset_weight: int = 14,
                 device: DeviceLike = "cuda") -> "SmallSetFlipDecoder":
        H = sparse.csr_matrix(H)
        V = H.shape[1]
        if sparse.csr_matrix(generators).shape[1] != V:
            raise ValueError("H and generators must share the qubit count")
        tables = _ssf_tables(H, generators, max_subset_weight)
        if max_iter <= 0:
            max_iter = V
        return cls(tables=tables, num_vars=V, max_iter=max_iter, device=device)

    def decode_tensors(self, syndromes: torch.Tensor):
        """(C, S) device syndromes -> (hard (V, S), conv, iters) tensors, in
        chunks of :func:`ssf_shot_chunk` shots."""
        R, K, _L = self.tables[2].shape
        S = syndromes.shape[1]
        free = torch.cuda.mem_get_info(self.device)[0] if self.device.type == "cuda" else None
        chunk = ssf_shot_chunk(R * K, S, free)
        outs = [ssf_core(*self._tables, syndromes[:, a:a + chunk], self.num_vars, self.max_iter)
                for a in range(0, max(S, 1), chunk)]
        if len(outs) == 1:
            return outs[0]
        return (torch.cat([o[0] for o in outs], dim=1), torch.cat([o[1] for o in outs]),
                torch.cat([o[2] for o in outs]))

    def decode_batch(self, syndromes: np.ndarray):
        s = torch.as_tensor(np.ascontiguousarray(np.asarray(syndromes, dtype=np.uint8).T))
        hard, conv, iters = self.decode_tensors(s.to(self.device))
        return hard.T.cpu().numpy(), conv.cpu().numpy(), iters.cpu().numpy()


def ssf_decode_numpy(H, generators, syndromes, max_iter: int = 0,
                     max_subset_weight: int = 14):
    """CPU oracle applying the identical greedy rule, subset enumeration
    order, and first-max tie-breaking (bit-exact vs the device kernel)."""
    gen_qubits, chk_ids, delta, sizes, bits = _ssf_tables(
        H, generators, max_subset_weight
    )
    Hd = _dense01(H)
    C, V = Hd.shape
    R, K, L = delta.shape
    if max_iter <= 0:
        max_iter = V
    inv_sizes = np.where(sizes > 0, 1.0 / np.maximum(sizes, 1.0), _NEG)

    syndromes = np.asarray(syndromes, dtype=np.uint8)
    S = syndromes.shape[0]
    e = np.zeros((S, V), np.uint8)
    s = syndromes.astype(np.float32).copy()
    conv = np.all(s == 0, axis=1)
    done = conv.copy()
    iters = np.zeros(S, np.int32)
    s_pad = np.zeros((S, C + 1), np.float32)
    for it in range(max_iter):
        if done.all():
            break
        s_pad[:, :C] = s
        s_loc = s_pad[:, chk_ids]  # (S, R, L)
        decrease = np.einsum("rkl,srl->srk", delta, 2.0 * s_loc - 1.0).astype(np.float32)
        ratio = (decrease * inv_sizes[None, None, :]).reshape(S, R * K)
        idx = np.argmax(ratio, axis=1)
        best = ratio[np.arange(S), idx]
        active = (best > 0) & ~done
        for i in np.nonzero(active)[0]:
            r, k = divmod(int(idx[i]), K)
            q = gen_qubits[r]
            b = bits[k].astype(np.uint8)
            real = q < V
            e[i, q[real]] ^= b[real]
            c = chk_ids[r]
            d = delta[r, k].astype(np.uint8)
            realc = c < C
            s[i, c[realc]] = (s[i, c[realc]] + d[realc]) % 2
            iters[i] = it + 1
        ok = np.all(s == 0, axis=1)
        conv |= ok & active
        done |= ok | ~active
    return e, conv, iters
