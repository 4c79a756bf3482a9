"""``bposd``: spacetime BP at fixed iterations on the card; its unconverged
shots are redecoded on the host by spacetime BP with the exit and OSD-CS."""
from __future__ import annotations

from ..work import st_bound_ms
from . import shipped

NUMBERS = shipped.NUMBERS


def device_stage(exp, hist, readout, precision: str):
    hard, _, conv = exp.bp("st", exp.st_syndromes(hist, readout), precision, "fixed")
    return exp.fold(hard), ~conv


def host_stage(exp, hist, readout, precision: str):
    est = exp.bposd("st", exp.st_syndromes(hist, readout).T, precision, exp.exit("spacetime"))
    return exp.fold(est.T)


def program_answer(exp, stages):
    if shipped.kinds(stages) != ["st"]:
        return None
    _, hard, conv = stages[0]
    return exp.fold(hard), ~conv


def compare(exp, k, device_precision, host_precision):
    return shipped.compare(exp, k, device_stage, host_stage, device_precision, host_precision)


def control_batch(exp, record, device_precision, host_precision):
    return shipped.control_batch(exp, record, device_stage, host_stage, device_precision,
                                 host_precision)


def bound_ms(h, rounds, shots, iters):
    return st_bound_ms(h, rounds, shots, iters)
