"""The memory experiment worked out again: noise model, decoders, verdicts.

Z-basis memory of a CSS code over R >= 2 rounds under phenomenological
noise with p = pm, as the storage circuit places it: every step that
measures starts with DEPOLARIZE1(p) on the data, and every measurement
(the checks' and the data readout's) is flipped with probability p.  So
in each round the data take the channel before the X checks are measured
(A, which the round's Z checks see) and before the Z checks are measured
(B, after the Z checks' gates: the next round sees it); the channel before
the readout lands inside the circuit's loop of rounds 2..R, so each of
those rounds ends with one more (C).  The Z checks of round t see 1 (t = 1)
or 3t - 3 channels, the readout 3R - 1.  A DEPOLARIZE1(p) flips a qubit's
X frame with probability 2p/3.  The record of a shot is, per round, the X
checks' then the Z checks' outcomes, then the n readout bits.

The decoders are min-sum BP on the spacetime matrix, (H|I) or H, and BP
with OSD-CS on its unconverged shots; each decode mode composes them into
its stages (``benchmark/modes/``).  A residual's verdict reads the Z
logicals the program reads: the code file's own where it has them, and
otherwise the canonical representatives (:func:`.codes.canonical_logicals`),
so that the two agree on every residual, one that leaves a syndrome too.
"""
from __future__ import annotations

import numpy as np
import torch

from . import bp as bpm
from .codes import canonical_logicals, llr, spacetime_matrix
from .osd import osd_cs


class Experiment:
    """One configuration's matrices, priors and Z logicals on ``device``
    (``lz``: the code file's; None: the canonical ones)."""

    def __init__(self, hx: np.ndarray, hz: np.ndarray, rounds: int, p: float, cfg: dict,
                 device, lz=None):
        self.dev = torch.device(device)
        self.h = np.asarray(hz, dtype=np.uint8) % 2
        self.r, self.n = self.h.shape
        self.x_count = np.asarray(hx).shape[0]
        self.rounds = R = int(rounds)
        if R < 2:
            raise ValueError("the noise model is stated for 2 rounds or more")
        self.p = float(p)
        pd = pm = cfg["prior_scale"] * self.p
        bp = cfg["bp"]
        self.iters, self.alpha = int(bp["max_iter"]), float(np.float32(bp["ms_scaling_factor"]))
        self.osd_order = int(cfg.get("osd", {}).get("order", 0))
        self.exits = cfg.get("redecode_exit", {})
        r, n, B = self.r, self.n, R + 1
        self.Hst = spacetime_matrix(self.h, R)
        self.HI = np.hstack([self.h, np.eye(r, dtype=np.uint8)])
        self.g_st = bpm.Graph(self.Hst, self.dev)
        self.g_HI = bpm.Graph(self.HI, self.dev)
        self.g_H = bpm.Graph(self.h, self.dev)
        self.meas_st = np.arange(self.Hst.shape[1]) >= B * n
        self.prior_st = llr(np.where(self.meas_st, pm, pd))
        self.prior_HI = llr(np.r_[np.full(n, pd), np.full(r, pm)])
        self.prior_H = llr(np.full(n, pd))
        L = canonical_logicals(self.h, np.asarray(hx) % 2) if lz is None else np.asarray(lz) % 2
        self.L = torch.as_tensor(L.astype(np.uint8)).to(self.dev)
        self.Ht = torch.as_tensor(self.h).to(self.dev)

    # ---- record layout and syndromes ------------------------------------
    def split(self, record: torch.Tensor):
        """(S, M) record -> Z-check history (S, R, r) and readout (S, n), uint8."""
        mpr = self.x_count + self.r
        S = record.shape[0]
        hist = record[:, : mpr * self.rounds].reshape(S, self.rounds, mpr)[:, :, self.x_count:]
        return hist.to(torch.uint8), record[:, mpr * self.rounds: mpr * self.rounds + self.n] \
            .to(torch.uint8)

    def syndrome(self, bits: torch.Tensor) -> torch.Tensor:
        """(S, n) 0/1 -> (S, r) uint8 syndrome under H."""
        return ((bits.float() @ self.Ht.T.float()) % 2).to(torch.uint8)

    def st_syndromes(self, hist, readout) -> torch.Tensor:
        """Differenced spacetime syndromes ((R+1) r, S)."""
        s = torch.cat([hist, self.syndrome(readout)[:, None]], dim=1)
        s = torch.cat([s[:, :1], s[:, 1:] ^ s[:, :-1]], dim=1)
        return s.reshape(s.shape[0], -1).T.contiguous()

    def fold(self, hard_st: torch.Tensor) -> torch.Tensor:
        """(Vst, S) spacetime estimate -> (S, n) mod-2 sum of its data blocks."""
        B, n = self.rounds + 1, self.n
        return (hard_st[: B * n].reshape(B, n, -1).sum(dim=0) % 2).T.to(torch.uint8)

    def verdict(self, readout, corr):
        """(valid, failed) per shot: the corrected readout has no syndrome,
        and it is a logical operator (some row of the Z logicals has odd
        overlap)."""
        res = readout ^ corr
        valid = (self.syndrome(res) == 0).all(dim=1)
        failed = ((res.float() @ self.L.T.float()) % 2 > 0.5).any(dim=1)
        return valid, failed

    # ---- decoders --------------------------------------------------------
    def bp(self, which: str, synd, precision: str, exit):
        g, prior = {"st": (self.g_st, self.prior_st), "HI": (self.g_HI, self.prior_HI),
                    "H": (self.g_H, self.prior_H)}[which]
        meas = self.meas_st if which == "st" else None
        low = precision != "float32"
        return bpm.decode(g, prior, synd, self.iters, self.alpha, precision, exit,
                          prior_first=None if low else meas, wide_in=meas if low else None)

    def exit(self, kind: str):
        """The redecode's exit on a ``spacetime`` or ``flat`` stage."""
        return self.exits.get(kind, "freeze")

    def bposd(self, which: str, synd_rows, precision: str, exit) -> torch.Tensor:
        """BP with the exit, then OSD-CS of its unconverged shots:
        (S, m) syndromes -> (S, N) estimates."""
        H = {"st": self.Hst, "HI": self.HI, "H": self.h}[which]
        hard, post, conv = self.bp(which, synd_rows.T.contiguous(), precision, exit)
        est = hard.T.clone()
        bad = torch.nonzero(~conv).flatten()
        if bad.numel():
            est[bad] = osd_cs(H, synd_rows[bad], post.T[bad], self.osd_order)
        return est

    # ---- the noise model -------------------------------------------------
    def expected_rates(self) -> tuple:
        """Exact probabilities that each Z-check outcome of round t (R, r)
        and each final detection event, readout syndrome XOR round R's
        outcome (r,), reads 1."""
        w = self.h.sum(axis=1).astype(np.float64)
        a = 1.0 - 4.0 * self.p / 3.0                 # 1 - 2 * (2p/3) per DEPOLARIZE1
        f = 1.0 - 2.0 * self.p
        raw = np.stack([(1 - a ** (max(1, 3 * t - 3) * w) * f) / 2
                        for t in range(1, self.rounds + 1)])
        final = (1 - a ** (2 * w) * f ** (1 + w)) / 2
        return raw, final

    def sample(self, S: int, gen: torch.Generator, resolution: int = 24) -> torch.Tensor:
        """(S, M) uint8 records drawn from the model, each uniform at
        ``resolution`` bits (24: float32's; 8: bfloat16's 8-bit significand
        as a fixed-point fraction).  X-check outcomes are left 0."""
        dev, n, r, R = self.dev, self.n, self.r, self.rounds
        scale = float(2 ** resolution)

        def bern(shape, q):
            u = torch.floor(torch.rand(shape, generator=gen, device=dev) * scale) / scale
            return u < q

        def depol(fx):
            k = torch.randint(1, 4, (S, n), generator=gen, device=dev)
            return fx ^ (bern((S, n), self.p) & (k % 2 == 1)).to(torch.uint8)

        fx = torch.zeros((S, n), dtype=torch.uint8, device=dev)
        blocks = []
        for t in range(R):
            fx = depol(fx)                                       # A
            z = self.syndrome(fx) ^ bern((S, r), self.p).to(torch.uint8)
            blocks += [torch.zeros((S, self.x_count), dtype=torch.uint8, device=dev), z]
            fx = depol(fx)                                       # B
            if t:
                fx = depol(fx)                                   # C
        blocks.append(fx ^ bern((S, n), self.p).to(torch.uint8))
        return torch.cat(blocks, dim=1)
