"""``relay_bp``: the relay BP ensemble on the spacetime matrix, on the card,
on every shot, and nothing after it; a shot fails where its folded
correction leaves a logical, solved or not.

A kept batch, as the ``relay_batch`` entry captures it: its ``record``;
``dev_corr`` and ``ship`` (the shots no leg solved), the program's answer
composed from its relay stage (``program_answer``); ``failures``, the
batch's failures as the program counts them.  A missing output (None)
fails the batch.

* ``device_mismatch``: shots whose convergence or correction differs from
  the reference's relay (:mod:`..reference.relay`);
* ``failure_gap``: the program's count of failures against the
  reference's verdicts on the program's own corrections: an exact
  comparison of the counting step.

The ensemble (legs, gamma0, the gamma range and seed) is the one the
``gross144x12relay`` configuration states (``benchmark/configs/
gross144x12relay.json``, the one configuration of this mode: the harness
hands a mode its experiment and not its configuration); the iterations a
leg and the scaling are the configuration's ``bp`` block, as the
experiment reads them.
"""
from __future__ import annotations

import json
from functools import lru_cache

from ..reference import relay
from ..work_relay import CONFIG, relay_bound_ms
from .shipped import kinds

NUMBERS = ("device_mismatch", "failure_gap")


@lru_cache(maxsize=None)
def ensemble() -> dict:
    """The configuration's ``relay`` block."""
    return json.loads(CONFIG.read_text())["relay"]


def decode(exp, hist, readout, precision: str):
    """The reference's relay on the batch's spacetime syndromes."""
    e = ensemble()
    gam = relay.gammas(e["legs"], exp.Hst.shape[1], e["gamma0"], e["gamma_range"], e["seed"])
    return relay.decode(exp.g_st, exp.prior_st, gam, exp.st_syndromes(hist, readout), exp.iters,
                        exp.alpha, precision)


def device_stage(exp, hist, readout, precision: str):
    hard, _post, conv, _leg = decode(exp, hist, readout, precision)
    return exp.fold(hard), ~conv


def program_answer(exp, stages):
    if kinds(stages) != ["relay"]:
        return None
    _, hard, conv = stages[0]
    return exp.fold(hard), ~conv


def compare(exp, k, device_precision, host_precision=None):
    hist, readout = exp.split(k["record"])
    S = hist.shape[0]
    if k.get("dev_corr") is None or k.get("ship") is None or k["ship"].shape[0] != S:
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
    return relay_bound_ms(h, rounds, shots, iters, int(ensemble()["legs"]))
