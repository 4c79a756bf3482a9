"""The reservoir of kept batches, and a kept batch whose outputs never
reached it."""
import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.capture import Reservoir
from benchmark.reference.experiment import Experiment
from benchmark.tests.conftest_paths import ROOT

CPU = torch.device("cpu")


def test_reservoir_keeps_k_uniformly():
    counts = np.zeros(40)
    for seed in range(400):
        res = Reservoir(4, seed)
        for i in range(40):
            res.offer(torch.tensor([i]))
        assert len(res.slots) == 4
        for k in res.slots:
            counts[int(k["record"])] += 1
    assert counts.min() > 0.5 * counts.mean() and counts.max() < 1.5 * counts.mean()


def test_reservoir_finds_by_identity():
    res = Reservoir(1, 7)
    first, second = torch.zeros(3), torch.zeros(3)
    keep = res.offer(first)
    out = object()
    res.tag(out, keep)
    assert res.find(first) is keep and res.find(out) is keep
    assert res.find(torch.zeros(3)) is None          # equal content, another batch
    while res.offer(second) is None:                 # until the slot goes to another batch
        second = torch.zeros(3)
    assert res.find(first) is None and res.find(out) is None
    res.enter(keep)
    assert res.active() is keep
    res.leave()
    assert res.active() is None


MISSING = [("hgp225x4.bposd", m) for m in ("ship", "dev_corr", "failures", "corr")] \
    + [("gross144x12.bp", m) for m in ("ship", "dev_corr", "failures")]


@pytest.mark.parametrize("cell, missing", MISSING)
def test_missing_output_fails(cell, missing):
    """A kept batch that lacks an output of the program reads as a
    mismatch of its shots, not as a smaller comparison."""
    torch.set_num_threads(1)
    _bench, _cell, cfg, traffic = harness.load(ROOT, cell)
    hx, hz, lz = harness.reference_matrices(cfg, ROOT)
    exp = Experiment(hx, hz, cfg["rounds"], 0.02, cfg, CPU, lz=lz)
    mode = harness.decode_mode(traffic)
    record = exp.sample(64, torch.Generator().manual_seed(3))
    k = mode.control_batch(exp, record, "float32", "float32")
    whole = mode.compare(exp, dict(k), "float32", "float32")
    assert all(v == 0 for v in whole.values()), whole
    assert int(k["ship"].sum()) > 0
    k[missing] = None
    broken = mode.compare(exp, k, "float32", "float32")
    assert any(v > traffic["limits"][n] for n, v in broken.items()), broken
