"""The memory experiment's decode modes on 0/1 tensors, written once.

The pipeline's device step (fixed-iteration BP stages, or the relay
ensemble in mode ``relay_bp``) and the host redecode drivers
(:mod:`.drivers`: BP with the exit, then OSD) run this algebra, each with
its own stages.  A stage maps (C, S) uint8 syndromes to
(hard (V, S) 0/1, conv (S,) bool).  history (S, rounds, r), readout (S, n)
and the checks H (r, n) are float32 0/1 on one device; a parity product is
a float32 matmul, exact for these small sums.  A mode returns (correction
(S, n) float32 0/1, ok (S,) bool), ok false where a stage did not converge.
"""
from __future__ import annotations

import torch

__all__ = ["parity", "spacetime_syndromes", "fold", "spacetime", "hybrid", "single_shot", "MODES"]


def parity(x: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """(S, n) 0/1 -> (S, r) 0/1: each check's parity of ``x``."""
    return torch.remainder(x @ H.T, 2.0)


def _stage_input(synd: torch.Tensor) -> torch.Tensor:
    """(S, C) 0/1 -> the (C, S) uint8 a stage takes."""
    return synd.T.to(torch.uint8).contiguous()


def spacetime_syndromes(H: torch.Tensor, history: torch.Tensor,
                        readout: torch.Tensor) -> torch.Tensor:
    """The differenced spacetime syndromes ((rounds+1)·r, S) uint8 of the
    rounds' syndromes and the final one from the readout."""
    S = history.shape[0]
    synd = torch.cat([history, parity(readout, H)[:, None, :]], dim=1)
    synd = torch.cat([synd[:, :1], torch.remainder(synd[:, 1:] + synd[:, :-1], 2.0)], dim=1)
    return _stage_input(synd.reshape(S, -1))


def fold(hard: torch.Tensor, rounds: int, n: int) -> torch.Tensor:
    """(Vst, S) spacetime hard decisions -> (S, n): the mod-2 sum of the data blocks."""
    blocks = hard[: (rounds + 1) * n].reshape(rounds + 1, n, hard.shape[1]).to(torch.int32)
    return (blocks.sum(dim=0) % 2).T.to(torch.float32)


def _final_round(H, readout, correction, decode):
    """``correction`` plus the stage's answer to the final round under it, and its conv."""
    hard, conv = decode(_stage_input(parity(torch.remainder(readout + correction, 2.0), H)))
    return torch.remainder(correction + hard.T.to(torch.float32), 2.0), conv


def spacetime(H, history, readout, decode):
    """Modes ``bposd`` and ``relay_bp``: one stage on the spacetime
    syndromes, its data blocks folded."""
    hard, conv = decode(spacetime_syndromes(H, history, readout))
    return fold(hard, history.shape[1], H.shape[1]), conv


def hybrid(H, history, readout, decode_spacetime, decode_final):
    """Mode ``bposd_hybrid``: the spacetime stage, then a stage on H of the
    final round; ok is the final stage's conv alone."""
    correction, _conv = spacetime(H, history, readout, decode_spacetime)
    return _final_round(H, readout, correction, decode_final)


def single_shot(H, history, readout, decode_round, decode_final):
    """Mode ``bposd_single_shot``: per round, a stage on (H|I) of the round's
    syndrome plus the syndrome of the correction so far, whose data part
    adds to the correction; then a stage on H of the final round."""
    n = H.shape[1]
    acc = torch.zeros_like(readout)
    ok = torch.ones(readout.shape[0], dtype=torch.bool, device=readout.device)
    for t in range(history.shape[1]):
        hard, conv = decode_round(_stage_input(torch.remainder(parity(acc, H) + history[:, t],
                                                               2.0)))
        acc = torch.remainder(acc + hard[:n].T.to(torch.float32), 2.0)
        ok = ok & conv
    correction, conv = _final_round(H, readout, acc, decode_final)
    return correction, ok & conv


MODES = {"bposd": spacetime, "bposd_hybrid": hybrid, "bposd_single_shot": single_shot,
         "relay_bp": spacetime}
