"""The check fails what it must: the control (the reference one precision
step down in the program's place) and runs whose timed path is broken
underneath, each at a size a test run can hold, on the CPU."""
import argparse
import time

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.control import control_numbers
from benchmark.tests.conftest_paths import ROOT
from exp_ldpc_tpu_torch.decoders import drivers
from exp_ldpc_tpu_torch.parallel.pipeline import StorageDecodePipeline

CPU = torch.device("cpu")
# the card's numerics on the CPU: the port's CPU redecode is float32 BP with
# per-shot freezing, which the reference then states
CPU_HOST = {"precision": {"device_stage": "float32", "host_redecode": "float32"},
            "redecode_exit": {"spacetime": "freeze", "flat": "freeze"}}
SIZES = {"hgp225x4.bposd": {"shots_per_batch": 4096, "compare_batches": 2},
         "hgp225x4.hybrid": {"shots_per_batch": 2048, "compare_batches": 2},
         "hgp225x4.single_shot": {"shots_per_batch": 2048, "compare_batches": 2},
         "gross144x12.bp": {"shots_per_batch": 2048, "compare_batches": 2}}
# the faults' runs: one unit, two batches of a sweep point, one of BP only
FAULT_SHOTS = {"hgp225x4.bposd": 2048, "hgp225x4.hybrid": 4096, "hgp225x4.single_shot": 2048,
               "gross144x12.bp": 1024}


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _run(cell, seed=2**31 + 101):
    args = argparse.Namespace(workload=cell, seed=seed, seconds=0.0, trace=0)
    bp = cell.startswith("gross")
    sizes = {"shots_per_batch": FAULT_SHOTS[cell], "compare_batches": 2, **CPU_HOST,
             "batches_per_point": 1 if bp else 2}
    result, _ = harness.run(args, ROOT, CPU, time.perf_counter(), sizes=sizes)
    return result


def _exceeds(checks):
    return [k for k, c in checks.items() if c["value"] > c["limit"]]


@pytest.mark.parametrize("cell", sorted(SIZES))
def test_control_is_not_correct(cell):
    limits = harness.load(ROOT, cell)[3]["limits"]
    nums = control_numbers(ROOT, cell, 5, CPU, sizes=SIZES[cell])
    assert [k for k, v in nums.items() if v > limits[k]], nums


def _half_batch(monkeypatch):
    """Half of the batch left out: the device decode sees the first half
    and reports the counts of a whole batch from it."""
    orig = StorageDecodePipeline._decode_records

    def half(self, record):
        out = orig(self, record[: record.shape[0] // 2])
        return (2 * out[0], 2 * out[1], 2 * out[2]) + tuple(out[3:])
    monkeypatch.setattr(StorageDecodePipeline, "_decode_records", half)


def _altered_correction(monkeypatch):
    """An answer altered where it is produced: the host redecode's
    correction of each shot has its first bit flipped."""
    for cls in (drivers.BPOSDCorrect, drivers.BPOSDHybridCorrect,
                drivers.BPOSDCorrectSingleShot):
        orig = cls.readout_correction_batch

        def flipped(self, hist, readout, _orig=orig):
            out = _orig(self, hist, readout).copy()
            out[:, 0] ^= 1
            return out
        monkeypatch.setattr(cls, "readout_correction_batch", flipped)


def _altered_record(monkeypatch):
    """An answer altered where it is produced: the sampler's records come
    out with every Z check's outcome of round 1 flipped in every shot."""
    import exp_ldpc_tpu_torch.parallel.pipeline as pl

    orig = pl.build_record_sampler

    def build(parsed, shots, dev):
        sample = orig(parsed, shots, dev)

        def altered(gen, args):
            rec = sample(gen, args).clone()
            rec[:, 108:216] ^= 1    # HGP-225: 108 X checks, then the 108 Z checks
            return rec
        return altered
    monkeypatch.setattr(pl, "build_record_sampler", build)


def _altered_conv(monkeypatch):
    """An answer altered where it is produced: the spacetime decode
    reports every shot's convergence flag inverted."""
    orig = StorageDecodePipeline.decode_spacetime

    def inverted(self, synd, max_iter=None):
        hard, conv = orig(self, synd, max_iter)
        return hard, ~conv
    monkeypatch.setattr(StorageDecodePipeline, "decode_spacetime", inverted)


def _half_spacetime(monkeypatch):
    """Half of the batch left out: the spacetime decode decodes the first
    half of the shots and repeats its results for the second."""
    orig = StorageDecodePipeline.decode_spacetime

    def half(self, synd, max_iter=None):
        S = synd.shape[1]
        hard, conv = orig(self, synd[:, : S // 2].contiguous(), max_iter)
        return torch.cat([hard, hard], dim=1)[:, :S], torch.cat([conv, conv])[:S]
    monkeypatch.setattr(StorageDecodePipeline, "decode_spacetime", half)


def _dropped_osd_failures(monkeypatch):
    """The count left short: the fold of a batch's failures drops the
    redecoded shots' failures."""
    orig = StorageDecodePipeline._finish_bposd

    def short(self, f_conv, shots, unconv, hist, readout, valid):
        out = orig(self, f_conv, shots, unconv, hist, readout, valid)
        return (f_conv,) + tuple(out[1:])
    monkeypatch.setattr(StorageDecodePipeline, "_finish_bposd", short)


def _logicals(monkeypatch, replace):
    """The failures counted with wrong Z logicals: ``replace(pipe)`` gives
    (host rows, device rows), None for the pipeline's own."""
    orig = StorageDecodePipeline.__post_init__

    def init(self):
        orig(self)
        host, dev = replace(self)
        if host is not None:
            self._Lz_np = np.asarray(host, dtype=np.int64)
        if dev is not None:
            self._Lz = torch.as_tensor(np.asarray(dev, dtype=np.float32)).to(self._Lz.device)
    monkeypatch.setattr(StorageDecodePipeline, "__post_init__", init)


def _with_check_row(pipe):
    """The Z logicals with the first replaced by a Z check: a residual that
    flips that logical alone is not counted."""
    L = pipe._Lz_np.copy()
    L[0] = pipe.code.checks.z.toarray()[0] % 2
    return L


def _host_logical_swapped(monkeypatch):
    _logicals(monkeypatch, lambda pipe: (_with_check_row(pipe), None))


def _device_logical_swapped(monkeypatch):
    _logicals(monkeypatch, lambda pipe: (None, _with_check_row(pipe)))


def _sector_swapped(monkeypatch):
    """The failures counted with the X logicals in place of the Z ones."""
    _logicals(monkeypatch, lambda pipe: (None, np.asarray(pipe.code.logicals.x) % 2))


FAULTS = [("hgp225x4.bposd", _dropped_osd_failures), ("hgp225x4.hybrid", _dropped_osd_failures),
          ("hgp225x4.bposd", _host_logical_swapped), ("hgp225x4.bposd", _device_logical_swapped),
          ("gross144x12.bp", _sector_swapped),
          ("hgp225x4.bposd", _half_batch), ("hgp225x4.bposd", _altered_correction),
          ("hgp225x4.hybrid", _half_batch), ("hgp225x4.hybrid", _altered_correction),
          ("hgp225x4.single_shot", _half_batch), ("hgp225x4.single_shot", _altered_correction),
          ("hgp225x4.hybrid", _altered_record),
          ("gross144x12.bp", _half_spacetime), ("gross144x12.bp", _altered_conv)]


@pytest.mark.parametrize("cell, fault", FAULTS, ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_broken_path_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    result = _run(cell)
    assert not result["correct"]
    assert _exceeds(result["checks"]), result["checks"]


def test_stages_reach_their_own_batch(monkeypatch):
    """Two batches in flight, finished in the other order than sampled (as
    an overlap of host and device runs them): each output is filed under
    its own batch, and the run reads correct."""
    def run_bposd(self, generator):
        one = self._decode_records(self._sample(generator, self._noise_args))
        two = self._decode_records(self._sample(generator, self._noise_args))
        a, b = self._finish_bposd(*two), self._finish_bposd(*one)
        return tuple(x + y for x, y in zip(a, b))
    monkeypatch.setattr(StorageDecodePipeline, "run_bposd", run_bposd)
    result = _run("hgp225x4.hybrid")
    assert result["correct"], result["checks"]
    assert all(c["value"] == 0 for k, c in result["checks"].items() if k != "sampler_z")
