"""Ordered-statistics decoding with a combination sweep (OSD-CS), batched
over shots in plain PyTorch.

Per shot (Roffe et al., arXiv:2005.07016): order the columns by the BP
posterior, most likely in error first (a stable sort of the LLRs); reduce
[H | s] over GF(2) in that order, so that the pivots are the first
independent columns; the candidates are the solution with every non-pivot
bit 0, then each single non-pivot bit set, then each pair within the first
``order`` non-pivot bits; a candidate costs the sum, over its set bits, of
log((1-q)/q) with q the posterior error probability (floored at 1e-9),
summed over the pivot bits in pivot order and then over its non-pivot
bits; the first candidate of least cost wins.  The shots of a chunk are
reduced together, their matrices held as bit-packed 64-bit words.
"""
from __future__ import annotations

import numpy as np
import torch

from .codes import rank as gf2_rank

CHUNK = 1024


def _costs(llr: torch.Tensor) -> torch.Tensor:
    x = llr.double().clamp(-30.0, 30.0)
    q = (1.0 / (1.0 + torch.exp(x))).clamp(1e-12, 1.0 - 1e-12)
    c = torch.log((1.0 - q) / q)
    return torch.where(c > 1e-9, c, torch.full_like(c, 1e-9))


def _pack(bits: torch.Tensor) -> torch.Tensor:
    """(..., L) 0/1 -> (..., ceil(L/64)) int64 words, bit j in word j//64."""
    L = bits.shape[-1]
    W = -(-L // 64)
    pad = torch.zeros(bits.shape[:-1] + (W * 64 - L,), dtype=torch.int64, device=bits.device)
    b = torch.cat([bits.to(torch.int64), pad], dim=-1).view(bits.shape[:-1] + (W, 64))
    return (b << torch.arange(64, device=bits.device)).sum(dim=-1)


def _unpack(words: torch.Tensor) -> torch.Tensor:
    """(..., W) int64 words -> (..., 64 W) uint8 bits."""
    b = (words[..., None] >> torch.arange(64, device=words.device)) & 1
    return b.reshape(words.shape[:-1] + (-1,)).to(torch.uint8)


def osd_cs(H: np.ndarray, synd: torch.Tensor, llr: torch.Tensor, order: int) -> torch.Tensor:
    """H (m, N) 0/1; synd (B, m) 0/1 and llr (B, N) on one device, every
    syndrome in H's column space -> (B, N) uint8 solutions of H e = s."""
    H = np.asarray(H, dtype=np.uint8) % 2
    target = gf2_rank(H)
    outs = [_osd_chunk(H, target, synd[i:i + CHUNK], llr[i:i + CHUNK], order)
            for i in range(0, synd.shape[0], CHUNK)]
    if not outs:
        return torch.zeros((0, H.shape[1]), dtype=torch.uint8, device=synd.device)
    return torch.cat(outs)


def _osd_chunk(H, target, synd, llr, order):
    dev = synd.device
    B = synd.shape[0]
    m, N = H.shape
    Ht = torch.as_tensor(H).to(dev)
    perm = torch.argsort(llr.double(), dim=1, stable=True)                # (B, N)
    cost = torch.gather(_costs(llr), 1, perm)                              # ordered columns
    aug = torch.cat([Ht.T[perm], synd.to(torch.uint8)[:, None, :]], dim=1)  # (B, N+1, m)
    A = _pack(aug.transpose(1, 2))                                         # (B, m, W)
    rows = torch.arange(m, device=dev)
    bidx = torch.arange(B, device=dev)
    rank = torch.zeros(B, dtype=torch.int64, device=dev)
    pivots = torch.zeros((B, m), dtype=torch.int64, device=dev)
    for j in range(N):
        if bool((rank >= target).all()):
            break
        col = (A[..., j // 64] >> (j % 64)) & 1                            # (B, m)
        free = (col == 1) & (rows[None, :] >= rank[:, None])
        has = free.any(dim=1)
        r = rank.clamp(max=m - 1)
        p = torch.where(has, free.to(torch.int8).argmax(dim=1), r)
        row_p, row_r = A[bidx, p], A[bidx, r]
        A[bidx, p] = row_r
        A[bidx, r] = row_p
        # the rows other than the new pivot row r that hold bit j, after the swap
        col_sw = col.clone()
        col_sw[bidx, p] = col[bidx, r]
        col_sw[bidx, r] = col[bidx, p]
        hit = (col_sw == 1) & has[:, None] & (rows[None, :] != r[:, None])
        A ^= row_p[:, None, :] & (-hit.to(torch.int64))[:, :, None]
        pivots[bidx, r] = torch.where(has, j, pivots[bidx, r])
        rank = rank + has.to(torch.int64)
    piv = pivots[:, :target]                                               # ascending
    is_piv = torch.zeros((B, N), dtype=torch.bool, device=dev)
    is_piv[bidx[:, None], piv] = True
    k = N - target
    nonpiv = torch.argsort(is_piv.to(torch.int8), dim=1, stable=True)[:, :k]
    bits = _unpack(A[:, :target])                                          # (B, rank, 64 W)
    s_red = bits[:, :, N]
    R_np = torch.gather(bits, 2, nonpiv[:, None, :].expand(B, target, k))  # (B, rank, k)
    c_piv = torch.gather(cost, 1, piv)
    c_np = torch.gather(cost, 1, nonpiv)
    w = min(order, k)
    pa = torch.tensor([a for a in range(w) for b in range(a + 1, w)], dtype=torch.int64,
                      device=dev)
    pb = torch.tensor([b for a in range(w) for b in range(a + 1, w)], dtype=torch.int64,
                      device=dev)
    flips = torch.cat([torch.zeros((B, target, 1), dtype=torch.uint8, device=dev), R_np,
                       R_np[:, :, pa] ^ R_np[:, :, pb]], dim=2)
    X = s_red[:, :, None] ^ flips                                          # candidates' pivot bits
    total = torch.zeros((B, X.shape[2]), dtype=torch.float64, device=dev)
    for i in range(target):
        total = total + torch.where(X[:, i] == 1, c_piv[:, i, None], 0.0)
    total[:, 1:1 + k] = total[:, 1:1 + k] + c_np
    total[:, 1 + k:] = total[:, 1 + k:] + c_np[:, pa]
    total[:, 1 + k:] = total[:, 1 + k:] + c_np[:, pb]
    best = torch.argmin(total, dim=1)                                      # first least cost
    x_ord = torch.zeros((B, N), dtype=torch.uint8, device=dev)
    x_ord[bidx[:, None], piv] = X[bidx, :, best]
    single = (best >= 1) & (best <= k)
    x_ord[bidx[single], nonpiv[single, best[single] - 1]] = 1
    pair = best > k
    q = best[pair] - 1 - k
    x_ord[bidx[pair], nonpiv[pair, pa[q]]] = 1
    x_ord[bidx[pair], nonpiv[pair, pb[q]]] = 1
    out = torch.zeros_like(x_ord)
    out.scatter_(1, perm, x_ord)
    return out
