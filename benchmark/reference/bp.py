"""Min-sum belief propagation on an explicit check matrix, in plain PyTorch.

One flooding decoder for every BP stage of the experiment: the spacetime
matrix, (H|I) and H.  Edges are laid out check-major with each check's
columns in ascending order, and each variable sums its incoming messages in
ascending row order; the check update is scaled min-sum whose ties go to
the first slot holding the minimum.  Messages are held in float32 tensors;
``precision`` says where they are rounded:

* ``"float32"``: nothing is rounded.  A variable's posterior is the sum of
  its messages, then its prior, except the columns in ``prior_first``,
  which start from the prior.
* ``"bfloat16"`` / ``"float8"``: every check-to-variable message is rounded
  to the type, except those into the columns in ``wide_in``; every
  posterior starts from the prior; a variable-to-check message is the
  rounded posterior less the rounded message, rounded (for ``wide_in``
  columns: the posterior less the unrounded message, rounded); the parity
  test reads the rounded posterior (``wide_in``: the unrounded one).

``exit`` is ``"fixed"`` (every iteration, converged = the final parity
test), ``"freeze"`` (each shot keeps its outputs from its first converged
iteration; the loop ends when all have converged) or a shot-block size
``G`` (shots in blocks of ``min(G, S rounded up to 128)``; a block stops
after the first iteration that leaves none of its shots unconverged; ``0``
stands for one block of all shots).  Hard decisions are ``posterior <= 0``.
"""
from __future__ import annotations

import numpy as np
import torch

BIG = 1e30
_TYPES = {"bfloat16": torch.bfloat16, "float8": torch.float8_e4m3fn}
_FP8_MAX = 448.0


def rounder(precision: str):
    """The rounding of a message type, on float32 tensors."""
    if precision == "float32":
        return lambda x: x
    dt = _TYPES[precision]
    if precision == "float8":
        return lambda x: x.clamp(-_FP8_MAX, _FP8_MAX).to(dt).float()
    return lambda x: x.to(dt).float()


class Graph:
    """The edge tables of a 0/1 matrix ``H`` (m, N) on ``device``."""

    def __init__(self, H: np.ndarray, device):
        H = np.asarray(H) % 2
        m, N = H.shape
        rows, cols = np.nonzero(H)                      # by (row, col)
        deg_c = np.bincount(rows, minlength=m)
        deg_v = np.bincount(cols, minlength=N)
        Dc, Dv = int(deg_c.max()), int(deg_v.max())
        cslot = np.arange(rows.size) - np.repeat(np.cumsum(deg_c) - deg_c, deg_c)
        chk_vars = np.zeros((m, Dc), dtype=np.int64)
        mask = np.zeros((m, Dc), dtype=bool)
        chk_vars[rows, cslot] = cols
        mask[rows, cslot] = True
        by_var = np.lexsort((rows, cols))               # by (col, row)
        vslot = np.arange(rows.size) - np.repeat(np.cumsum(deg_v) - deg_v, deg_v)
        vm = np.full((N, Dv), m * Dc, dtype=np.int64)  # pads read an appended zero row
        vm[cols[by_var], vslot] = rows[by_var] * Dc + cslot[by_var]
        self.shape, self.Dc, self.Dv, self.nnz = (m, N), Dc, Dv, int(rows.size)
        self.H = torch.as_tensor(H.astype(np.uint8)).to(device)
        self.chk_vars = torch.as_tensor(chk_vars).to(device)
        self.mask = torch.as_tensor(mask).to(device)
        self.vm = torch.as_tensor(vm).to(device)
        self.device = torch.device(device)

    def parity(self, bits: torch.Tensor) -> torch.Tensor:
        """(N, S) 0/1 -> (m, S) int32 syndrome."""
        b = bits.to(torch.int32)[self.chk_vars]                            # (m, Dc, S)
        return torch.where(self.mask[:, :, None], b, 0).sum(dim=1) % 2


def _check_update(v2c: torch.Tensor, synd_sign: torch.Tensor, alpha: float) -> torch.Tensor:
    sign = torch.where(v2c < 0, -1.0, 1.0)
    mag = v2c.abs()
    ext_sign = torch.prod(sign, dim=1, keepdim=True) * synd_sign[:, None, :] * sign
    min1 = mag.min(dim=1, keepdim=True).values
    hit = mag == min1
    is_min = hit & (torch.cumsum(hit.to(torch.int32), dim=1) == 1)
    min2 = torch.where(is_min, BIG, mag).min(dim=1, keepdim=True).values
    return ext_sign * torch.where(is_min, min2, min1) * alpha


def decode(g: Graph, prior: np.ndarray, synd: torch.Tensor, iters: int, alpha: float,
           precision: str = "float32", exit="fixed", prior_first=None, wide_in=None):
    """Syndromes (m, S) 0/1 on ``g``'s device -> (hard (N, S) uint8,
    posterior (N, S) float32, converged (S,) bool).  ``prior`` is (N,)
    float32 LLRs; ``prior_first`` / ``wide_in`` are (N,) bool column masks
    (module docstring)."""
    m, N = g.shape
    dev = g.device
    S = synd.shape[1]
    rnd = rounder(precision)
    low = precision != "float32"
    prior_t = torch.as_tensor(np.asarray(prior, dtype=np.float32)).to(dev)
    col_mask = lambda x: torch.zeros(N, dtype=torch.bool, device=dev) if x is None \
        else torch.as_tensor(np.asarray(x, dtype=bool)).to(dev)   # noqa: E731
    first = torch.ones(N, dtype=torch.bool, device=dev) if low else col_mask(prior_first)
    wide = col_mask(wide_in) if low else torch.ones(N, dtype=torch.bool, device=dev)
    wide_edge = wide[g.chk_vars][:, :, None]
    synd = synd.to(torch.int32)
    synd_sign = 1.0 - 2.0 * synd.float()
    mask3 = g.mask[:, :, None]
    v2c = torch.where(mask3, rnd(prior_t[g.chk_vars])[:, :, None].expand(m, g.Dc, S), BIG)
    zero_row = torch.zeros((1, S), device=dev)

    def step(v2c):
        raw = _check_update(v2c, synd_sign, alpha)
        c2v = torch.where(wide_edge, raw, rnd(raw))
        flat = torch.cat([c2v.reshape(m * g.Dc, S), zero_row])[g.vm]       # (N, Dv, S)
        acc_m = flat[:, 0]
        acc_p = prior_t[:, None] + flat[:, 0]
        for j in range(1, g.Dv):
            acc_m = acc_m + flat[:, j]
            acc_p = acc_p + flat[:, j]
        post = torch.where(first[:, None], acc_p, acc_m + prior_t[:, None])
        post_r = torch.where(wide[:, None], post, rnd(post))
        new = rnd(post_r[g.chk_vars] - c2v)
        return torch.where(mask3, new, BIG), post, post_r

    def ok(post_r):
        return (g.parity(post_r <= 0) == synd).all(dim=0)

    post = prior_t[:, None].expand(N, S).clone()
    if exit == "fixed":
        for _ in range(iters):
            v2c, post, _ = step(v2c)
        return (post <= 0).to(torch.uint8), post, ok(torch.where(wide[:, None], post, rnd(post)))
    if exit == "freeze":
        hard = (post <= 0).to(torch.uint8)
        conv = torch.zeros(S, dtype=torch.bool, device=dev)
        for _ in range(iters):
            if bool(conv.all()):
                break
            v2c, p_new, p_r = step(v2c)
            now = ok(p_r)
            hard = torch.where(conv[None], hard, (p_new <= 0).to(torch.uint8))
            post = torch.where(conv[None], post, p_new)
            conv = conv | now
        return hard, post, conv
    G = int(exit)
    sb = S if G == 0 else max(1, min(G, -(-S // 128) * 128))
    grp = torch.arange(S, device=dev) // sb
    nblk = -(-S // sb) if S else 0
    running = torch.ones(nblk, dtype=torch.bool, device=dev)
    post_r = torch.where(wide[:, None], post, rnd(post))
    for _ in range(iters):
        if not bool(running.any()):
            break
        v2c_new, p_new, pr_new = step(v2c)
        run = running[grp]
        v2c = torch.where(run[None, None], v2c_new, v2c)
        post = torch.where(run[None], p_new, post)
        post_r = torch.where(run[None], pr_new, post_r)
        bad = (~ok(post_r)).to(torch.int32)
        running = running & (torch.zeros(nblk, dtype=torch.int32, device=dev)
                             .index_add_(0, grp, bad) > 0)
    return (post <= 0).to(torch.uint8), post, ok(post_r)
