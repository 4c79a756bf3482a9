"""``bposd_single_shot``: per round, BP on (H|I) of the round's syndrome
plus the syndrome of the correction so far, then BP on H of the final
round, all at fixed iterations on the card; a shot unconverged in any
stage is redecoded on the host, every stage as BP with the exit and
OSD-CS."""
from __future__ import annotations

import torch

from ..work import flat_bound_ms, with_identity
from . import shipped

NUMBERS = shipped.NUMBERS


def device_stage(exp, hist, readout, precision: str):
    S = hist.shape[0]
    acc = torch.zeros((S, exp.n), dtype=torch.uint8, device=exp.dev)
    bad = torch.zeros(S, dtype=torch.bool, device=exp.dev)
    for t in range(exp.rounds):
        s_t = (exp.syndrome(acc) ^ hist[:, t]).T.contiguous()
        hard, _, conv = exp.bp("HI", s_t, precision, "fixed")
        acc = acc ^ hard[: exp.n].T
        bad = bad | ~conv
    hard, _, conv = exp.bp("H", exp.syndrome(acc ^ readout).T.contiguous(), precision, "fixed")
    return acc ^ hard.T, bad | ~conv


def host_stage(exp, hist, readout, precision: str):
    ex = exp.exit("flat")
    acc = torch.zeros_like(readout)
    for t in range(exp.rounds):
        acc = acc ^ exp.bposd("HI", exp.syndrome(acc) ^ hist[:, t], precision, ex)[:, : exp.n]
    return acc ^ exp.bposd("H", exp.syndrome(acc ^ readout), precision, ex)


def program_answer(exp, stages):
    if shipped.kinds(stages) != ["flat"] * (exp.rounds + 1):
        return None
    acc = bad = None
    for _, hard, conv in stages:
        part = hard[: exp.n].T.to(torch.uint8)
        acc = part if acc is None else acc ^ part
        bad = ~conv if bad is None else bad | ~conv
    return acc, bad


def compare(exp, k, device_precision, host_precision):
    return shipped.compare(exp, k, device_stage, host_stage, device_precision, host_precision)


def control_batch(exp, record, device_precision, host_precision):
    return shipped.control_batch(exp, record, device_stage, host_stage, device_precision,
                                 host_precision)


def bound_ms(h, rounds, shots, iters):
    return rounds * flat_bound_ms(with_identity(h), shots, iters) + flat_bound_ms(h, shots, iters)
