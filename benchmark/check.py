"""The comparison that decides ``correct``: the window's kept batches
against the plain reference (:mod:`benchmark.reference`).

``sampler_z``, the largest |t| of a per-shot count against its exact
expectation under the noise model, over the kept batches' shots: per
round the Z-check outcomes that read 1, and the final detection events
(readout syndrome XOR the last round's outcomes).  The reference decodes
the program's own records, so the sampler is judged by this number alone.
The decode mode's module (``benchmark/modes/``) adds its own numbers of
each kept batch.  Each number has a limit in the cell's traffic file.
"""
from __future__ import annotations

import math


def sampler_z(exp, records) -> float:
    raw, final = exp.expected_rates()
    expect = [float(x.sum()) for x in raw] + [float(final.sum())]
    sums = [0.0] * len(expect)
    sq = [0.0] * len(expect)
    S = 0
    for record in records:
        hist, readout = exp.split(record)
        R = hist.shape[1]
        counts = [hist[:, t].sum(dim=1) for t in range(R)]
        counts.append((exp.syndrome(readout) ^ hist[:, R - 1]).sum(dim=1))
        for g, c in enumerate(counts):
            c = c.double()
            sums[g] += float(c.sum())
            sq[g] += float((c * c).sum())
        S += hist.shape[0]
    if S < 2:
        return math.inf
    worst = 0.0
    for g, e in enumerate(expect):
        mean = sums[g] / S
        var = max(sq[g] / S - mean * mean, 1e-12) * S / (S - 1)
        worst = max(worst, abs(mean - e) / math.sqrt(var / S))
    return worst


def numbers(exp, mode, kept: list, device_precision: str, host_precision: str) -> dict:
    """The check's numbers over the kept batches: ``sampler_z`` and the
    sums of ``mode.compare``'s."""
    out = {"sampler_z": sampler_z(exp, [k["record"] for k in kept]),
           **dict.fromkeys(mode.NUMBERS, 0)}
    for k in kept:
        for name, v in mode.compare(exp, k, device_precision, host_precision).items():
            out[name] += v
    return out
