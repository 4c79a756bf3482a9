"""``bposd_hybrid``: spacetime BP, then BP on H of the final round's
syndrome, both at fixed iterations on the card; the shots the final stage
leaves unconverged are redecoded on the host: spacetime BP with the exit,
then BP with the exit and OSD-CS on H."""
from __future__ import annotations

from ..work import flat_bound_ms, st_bound_ms
from . import shipped

NUMBERS = shipped.NUMBERS


def device_stage(exp, hist, readout, precision: str):
    hard, _, _ = exp.bp("st", exp.st_syndromes(hist, readout), precision, "fixed")
    corr = exp.fold(hard)
    hard, _, conv = exp.bp("H", exp.syndrome(corr ^ readout).T.contiguous(), precision, "fixed")
    return corr ^ hard.T, ~conv


def host_stage(exp, hist, readout, precision: str):
    hard, _, _ = exp.bp("st", exp.st_syndromes(hist, readout), precision, exp.exit("spacetime"))
    corr = exp.fold(hard)
    return corr ^ exp.bposd("H", exp.syndrome(corr ^ readout), precision, exp.exit("flat"))


def program_answer(exp, stages):
    if shipped.kinds(stages) != ["st", "flat"]:
        return None
    (_, hard_st, _), (_, hard_f, conv_f) = stages
    return exp.fold(hard_st) ^ hard_f[: exp.n].T.to(hard_st.dtype), ~conv_f


def compare(exp, k, device_precision, host_precision):
    return shipped.compare(exp, k, device_stage, host_stage, device_precision, host_precision)


def control_batch(exp, record, device_precision, host_precision):
    return shipped.control_batch(exp, record, device_stage, host_stage, device_precision,
                                 host_precision)


def bound_ms(h, rounds, shots, iters):
    return st_bound_ms(h, rounds, shots, iters) + flat_bound_ms(h, shots, iters)
