"""``bp``: spacetime BP at fixed iterations on the card on every shot, and
nothing after it; a shot fails where its folded correction leaves a logical
(converged or not).

A kept batch, as the ``bp_batch`` entry captures it: its ``record``;
``dev_corr`` and ``ship`` (its unconverged shots), the program's answer
composed from its spacetime stage (``program_answer``); ``failures``, the
batch's failures as the program counts them.  A missing output (None)
fails the batch.

* ``device_mismatch``: shots whose convergence or correction differs from
  the reference's;
* ``failure_gap``: the program's count of failures against the
  reference's verdicts on the program's own corrections: an exact
  comparison of the counting step.
"""
from __future__ import annotations

from ..work import st_bound_ms
from .shipped import kinds

NUMBERS = ("device_mismatch", "failure_gap")


def device_stage(exp, hist, readout, precision: str):
    hard, _, conv = exp.bp("st", exp.st_syndromes(hist, readout), precision, "fixed")
    return exp.fold(hard), ~conv


def program_answer(exp, stages):
    if kinds(stages) != ["st"]:
        return None
    _, hard, conv = stages[0]
    return exp.fold(hard), ~conv


def compare(exp, k, device_precision, host_precision=None):
    hist, readout = exp.split(k["record"])
    S = hist.shape[0]
    if k.get("dev_corr") is None or k.get("ship") is None:
        return dict.fromkeys(NUMBERS, S)
    corr_r, ship_r = device_stage(exp, hist, readout, device_precision)
    differ = (k["ship"] ^ ship_r) | (k["dev_corr"] != corr_r).any(dim=1)
    out = {"device_mismatch": int(differ.sum()), "failure_gap": S}
    if k.get("failures") is not None:
        out["failure_gap"] = abs(k["failures"] - int(exp.verdict(readout, k["dev_corr"])[1].sum()))
    return out


def control_batch(exp, record, device_precision, host_precision=None):
    hist, readout = exp.split(record)
    corr, ship = device_stage(exp, hist, readout, device_precision)
    return {"record": record, "dev_corr": corr, "ship": ship,
            "failures": int(exp.verdict(readout, corr)[1].sum())}


def bound_ms(h, rounds, shots, iters):
    return st_bound_ms(h, rounds, shots, iters)
