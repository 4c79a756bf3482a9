"""The relay BP ensemble (Relay-BP, arXiv:2507.00254) in plain PyTorch.

Legs of flooding min-sum BP on an explicit check matrix (:class:`.bp.Graph`,
its check update and edge order), whose variable update keeps a memory
term:

    lam_j(t) = (1 - g_j) * (prior_j + sum_i c2v_ij) + g_j * lam_j(t - 1),

with v2c = lam[var] - c2v and lam(0) the prior.  The sum runs left to right
over the variable's edges in ascending row order, and each product and sum
is one float32 operation.  Leg 0 takes ``gamma0`` for every variable; legs
1 on draw each variable's g uniformly from ``gamma_range`` with numpy's
``default_rng(seed)``, one (legs, N) draw whose first row is then replaced,
as the reference project's decoder draws them.  The messages and lam carry
over from one leg to the next, and the iteration count that sets an
adaptive scaling restarts each leg.  A shot keeps the first leg whose hard
decision (lam <= 0) satisfies its syndrome; a shot no leg solves reports the
last leg's lam.

``precision`` "float32" rounds nothing; "bfloat16" (the control) rounds every
check-to-variable message, every lam and every variable-to-check message to
bfloat16.
"""
from __future__ import annotations

import numpy as np
import torch

from . import bp as bpm

# float32 products in this module's matrix algebra, not TF32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def gammas(legs: int, N: int, gamma0: float, gamma_range, seed: int) -> np.ndarray:
    """The (legs, N) float32 memory strengths of the ensemble."""
    g = np.random.default_rng(int(seed)).uniform(float(gamma_range[0]), float(gamma_range[1]),
                                                 size=(int(legs), int(N)))
    g[0, :] = float(gamma0)
    return g.astype(np.float32)


def decode(g: bpm.Graph, prior: np.ndarray, gam: np.ndarray, synd: torch.Tensor, iters: int,
           alpha: float, precision: str = "float32"):
    """Syndromes (m, S) 0/1 on ``g``'s device -> (hard (N, S) uint8,
    posterior (N, S) float32, converged (S,) bool, solved leg (S,) int32,
    the number of legs where none solved the shot)."""
    m, N = g.shape
    dev = g.device
    S = synd.shape[1]
    legs = int(gam.shape[0])
    rnd = bpm.rounder(precision)
    prior_t = torch.as_tensor(np.asarray(prior, dtype=np.float32)).to(dev)
    gam_t = torch.as_tensor(np.asarray(gam, dtype=np.float32)).to(dev)
    synd = synd.to(torch.int32)
    synd_sign = 1.0 - 2.0 * synd.float()
    mask3 = g.mask[:, :, None]
    v2c = torch.where(mask3, rnd(prior_t[g.chk_vars])[:, :, None].expand(m, g.Dc, S), bpm.BIG)
    zero_row = torch.zeros((1, S), device=dev)
    lam = prior_t[:, None].expand(N, S).clone()
    hard = torch.zeros((N, S), dtype=torch.uint8, device=dev)
    post = lam.clone()
    conv = torch.zeros(S, dtype=torch.bool, device=dev)
    solved = torch.full((S,), legs, dtype=torch.int32, device=dev)
    for leg in range(legs):
        gl = gam_t[leg][:, None]
        for it in range(iters):
            a = alpha if alpha != 0.0 else float(np.float32(1.0 - 2.0 ** -(it + 1)))
            c2v = rnd(bpm._check_update(v2c, synd_sign, a))
            flat = torch.cat([c2v.reshape(m * g.Dc, S), zero_row])[g.vm]       # (N, Dv, S)
            total = flat[:, 0]
            for j in range(1, g.Dv):
                total = total + flat[:, j]
            lam = rnd((1.0 - gl) * (prior_t[:, None] + total) + gl * lam)
            v2c = torch.where(mask3, rnd(lam[g.chk_vars] - c2v), bpm.BIG)
        hard_now = (lam <= 0).to(torch.uint8)
        newly = (g.parity(hard_now) == synd).all(dim=0) & ~conv
        hard = torch.where(newly[None], hard_now, hard)
        post = torch.where(newly[None], lam, post)
        solved = torch.where(newly, leg, solved)
        conv = conv | newly
    hard = torch.where(conv[None], hard, (lam <= 0).to(torch.uint8))
    post = torch.where(conv[None], post, lam)
    return hard, post, conv, solved
