"""What the three pipeline modes share: a device stage on every shot, whose
unconverged shots go to a BP+OSD redecode on the host.

A kept batch, as the ``sweep_point`` entry captures it: its ``record``;
``ship``, the shots the program shipped (found by their rows, which come
compacted in order) and ``unmatched``, shipped rows that are no rows of
the batch; ``f_kept``, the program's failures among the shots it kept;
``corr``, its redecode's corrections of the shipped shots; ``dev_corr``,
its device stage's corrections of every shot (``program_answer``); and
``failures``, the batch's failures as the program counts them.  A missing
output (None) fails the batch.

* ``device_mismatch``: shots shipped on one side only, plus the gap in
  failures among kept shots, plus unmatched rows;
* ``host_mismatch``: shots shipped on both sides whose redecoded
  correction leaves a syndrome or whose verdict differs from the
  reference's redecode of the program's shipped shots;
* ``failure_gap``: the program's count of failures against the
  reference's verdicts on the program's own answers, the device stage's
  for the shots it kept and the redecode's for the shots it shipped: an
  exact comparison of the step that folds them.
"""
from __future__ import annotations

import torch

NUMBERS = ("device_mismatch", "host_mismatch", "failure_gap")


def compare(exp, k: dict, device_stage, host_stage, device_precision: str,
            host_precision: str) -> dict:
    hist, readout = exp.split(k["record"])
    S = hist.shape[0]
    if k.get("ship") is None or k.get("f_kept") is None:
        return dict.fromkeys(NUMBERS, S)
    corr_r, ship_r = device_stage(exp, hist, readout, device_precision)
    _v, fail_r = exp.verdict(readout, corr_r)
    ship_p, unmatched = k["ship"], k["unmatched"]
    out = {"device_mismatch": int((ship_p ^ ship_r).sum()) + unmatched
           + abs(k["f_kept"] - int((fail_r & ~ship_r).sum()))}
    n_ship = int(ship_p.sum())
    corr_p = k.get("corr")
    if unmatched or (n_ship and (corr_p is None or corr_p.shape[0] != n_ship)):
        out["host_mismatch"] = out["failure_gap"] = n_ship + unmatched
        return out
    idx = torch.nonzero(ship_p).flatten()
    out["host_mismatch"] = 0
    fail_host = torch.zeros(0, dtype=torch.bool, device=readout.device)
    if n_ship:
        corr_h = host_stage(exp, hist[idx], readout[idx], host_precision)
        _v, fail_h = exp.verdict(readout[idx], corr_h)
        valid_p, fail_host = exp.verdict(readout[idx], corr_p)
        both = ship_r[idx]
        out["host_mismatch"] = int((both & (~valid_p | (fail_host ^ fail_h))).sum())
    if k.get("dev_corr") is None or k.get("failures") is None:
        out["failure_gap"] = S
        return out
    _v, fail_dev = exp.verdict(readout, k["dev_corr"])
    recount = int((fail_dev & ~ship_p).sum()) + int(fail_host.sum())
    out["failure_gap"] = abs(k["failures"] - recount)
    return out


def control_batch(exp, record, device_stage, host_stage, device_precision: str,
                  host_precision: str) -> dict:
    hist, readout = exp.split(record)
    corr, ship = device_stage(exp, hist, readout, device_precision)
    _v, fail = exp.verdict(readout, corr)
    f_kept = int((fail & ~ship).sum())
    idx = torch.nonzero(ship).flatten()
    host, f_host = None, 0
    if idx.numel():
        host = host_stage(exp, hist[idx], readout[idx], host_precision)
        f_host = int(exp.verdict(readout[idx], host)[1].sum())
    return {"record": record, "ship": ship, "unmatched": 0, "f_kept": f_kept, "corr": host,
            "dev_corr": corr, "failures": f_kept + f_host}


def kinds(stages) -> list:
    return [s[0] for s in stages]
