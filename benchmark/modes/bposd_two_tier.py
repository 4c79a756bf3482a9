"""``bposd`` with ``tier1_iters`` (the two-tier decode): spacetime BP at
``tier1_iters`` fixed iterations on every shot on the card, then the first
``tier2_cap`` shots of the stable order "unconverged first" redecoded from
scratch at the configuration's ``max_iter``; a redecoded shot takes its
second result where the first left it unconverged, and the others keep
theirs.  Shots the merged stage leaves unconverged are redecoded on the
host as in ``bposd``: spacetime BP with the exit, then OSD-CS.

``tier1_iters`` is the traffic's option (``benchmark/traffic/
hgp225x4.two_tier.json``, the one cell of this mode: the harness hands a
mode its experiment and not its traffic) and ``tier2_cap`` the pipeline's
default, max(128, shots // 4) clipped to the batch.

The program's two spacetime stages arrive in call order; its merge writes
the second stage's results into the first stage's outputs in place
(``StorageDecodePipeline.decode_two_tier``), so the first stage, as the
entry kept it, holds the merged answer.
"""
from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path

import torch

from ..reference import bp as bpm
from ..work import st_bound_ms
from . import bposd, shipped

NUMBERS = shipped.NUMBERS
TRAFFIC = Path(__file__).resolve().parents[1] / "traffic" / "hgp225x4.two_tier.json"
host_stage = bposd.host_stage


@lru_cache(maxsize=None)
def tier1_iters() -> int:
    return int(json.loads(TRAFFIC.read_text())["options"]["tier1_iters"])


def tier2_cap(shots: int) -> int:
    return min(max(128, shots // 4), shots)


def _stage(exp, synd, iters: int, precision: str):
    low = precision != "float32"
    return bpm.decode(exp.g_st, exp.prior_st, synd, iters, exp.alpha, precision, "fixed",
                      prior_first=None if low else exp.meas_st,
                      wide_in=exp.meas_st if low else None)


def device_stage(exp, hist, readout, precision: str):
    synd = exp.st_syndromes(hist, readout)
    hard, _, conv = _stage(exp, synd, tier1_iters(), precision)
    order = torch.argsort(conv.to(torch.int32), stable=True)[: tier2_cap(synd.shape[1])]
    hard2, _, conv2 = _stage(exp, synd[:, order].contiguous(), exp.iters, precision)
    take = ~conv[order]
    hard[:, order] = torch.where(take[None], hard2, hard[:, order])
    conv[order] = conv[order] | conv2
    return exp.fold(hard), ~conv


def program_answer(exp, stages):
    if shipped.kinds(stages) != ["st", "st"]:
        return None
    _, hard, conv = stages[0]
    return exp.fold(hard), ~conv


def compare(exp, k, device_precision, host_precision):
    return shipped.compare(exp, k, device_stage, host_stage, device_precision, host_precision)


def control_batch(exp, record, device_precision, host_precision):
    return shipped.control_batch(exp, record, device_stage, host_stage, device_precision,
                                 host_precision)


def bound_ms(h, rounds, shots, iters):
    return (st_bound_ms(h, rounds, shots, tier1_iters())
            + st_bound_ms(h, rounds, tier2_cap(shots), iters))
