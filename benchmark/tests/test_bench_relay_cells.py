"""The cells of the relay ensemble (``gross144x12relay.relay``) and of the
two-tier decode (``hgp225x4.two_tier``), on the CPU at a size a test run can
hold: they load, a run of each reads correct, the relay cell's check fails
each kind of fault it can see, the control fails both, and the relay bound
reads its configuration's shape."""
import argparse
import time

import numpy as np
import pytest
import torch

from benchmark import harness, work_relay
from benchmark.control import control_numbers
from benchmark.tests.conftest_paths import ROOT
from exp_ldpc_tpu_torch.parallel.pipeline import StorageDecodePipeline

CPU = torch.device("cpu")
RELAY, TWO_TIER = "gross144x12relay.relay", "hgp225x4.two_tier"
SIZES = {RELAY: {"rounds": 2, "shots_per_batch": 512, "compare_batches": 2},
         TWO_TIER: {"shots_per_batch": 1024, "batches_per_point": 2, "compare_batches": 2,
                    "precision": {"device_stage": "float32", "host_redecode": "float32"},
                    "redecode_exit": {"spacetime": "freeze", "flat": "freeze"}}}
# the control's batches: enough shots that its 8-bit uniforms show in sampler_z
CONTROL_SIZES = {RELAY: {"shots_per_batch": 1024, "compare_batches": 2},
                 TWO_TIER: {**SIZES[TWO_TIER], "shots_per_batch": 4096}}


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _run(cell, seed=2**31 + 303):
    args = argparse.Namespace(workload=cell, seed=seed, seconds=0.0, trace=0)
    result, _ = harness.run(args, ROOT, CPU, time.perf_counter(), sizes=SIZES[cell])
    return result


@pytest.mark.parametrize("cell, mode", [(RELAY, "relay_bp"), (TWO_TIER, "bposd_two_tier")])
def test_cells_load(cell, mode):
    bench, w, cfg, traffic = harness.load(ROOT, cell)
    assert w["chips"] == 1 and harness.decode_mode(traffic).__name__ == f"benchmark.modes.{mode}"
    assert harness.metric_names(bench, cell, "per_layer")


@pytest.mark.parametrize("cell", [RELAY, TWO_TIER])
def test_run_is_correct(cell):
    result = _run(cell)
    assert result["correct"], result["checks"]
    assert all(c["value"] == 0 for k, c in result["checks"].items() if k != "sampler_z")


@pytest.mark.parametrize("cell", [RELAY, TWO_TIER])
def test_control_is_not_correct(cell):
    limits = harness.load(ROOT, cell)[3]["limits"]
    nums = control_numbers(ROOT, cell, 5, CPU, sizes=CONTROL_SIZES[cell])
    assert [k for k, v in nums.items() if v > limits[k]], nums


def test_work_relay_reads_its_configuration():
    assert work_relay.config_shape() == (936, 2736, 7344, 20000, 30, 8)


def _patch_relay(monkeypatch, alter):
    orig = StorageDecodePipeline.decode_relay

    def altered(self, synd):
        return alter(self, synd, orig)
    monkeypatch.setattr(StorageDecodePipeline, "decode_relay", altered)


def _altered_conv(monkeypatch):
    """The relay reports every shot's convergence inverted."""
    _patch_relay(monkeypatch, lambda self, s, orig: (lambda h, c, l: (h, ~c, l))(*orig(self, s)))


def _altered_correction(monkeypatch):
    """The relay's hard decision of each shot has its first bit flipped."""
    def alter(self, synd, orig):
        hard, conv, legs = orig(self, synd)
        hard = hard.clone()
        hard[0] ^= 1
        return hard, conv, legs
    _patch_relay(monkeypatch, alter)


def _half_relay(monkeypatch):
    """The relay decodes the first half of the shots and repeats its
    results for the second."""
    def alter(self, synd, orig):
        S = synd.shape[1]
        h, c, l = orig(self, synd[:, : S // 2].contiguous())
        return (torch.cat([h, h], dim=1)[:, :S], torch.cat([c, c])[:S],
                torch.cat([l, l])[:S])
    _patch_relay(monkeypatch, alter)


def _half_batch(monkeypatch):
    """The decode sees the first half of the batch and reports the counts of
    a whole batch from it."""
    orig = StorageDecodePipeline._decode_records

    def half(self, record):
        out = orig(self, record[: record.shape[0] // 2])
        return (2 * out[0], 2 * out[1], 2 * out[2]) + tuple(out[3:])
    monkeypatch.setattr(StorageDecodePipeline, "_decode_records", half)


def _altered_record(monkeypatch):
    """The sampler's records come out with every Z check's outcome of round
    1 flipped (the gross code: 72 X checks, then the 72 Z checks)."""
    import exp_ldpc_tpu_torch.parallel.pipeline as pl

    orig = pl.build_record_sampler

    def build(parsed, shots, dev):
        sample = orig(parsed, shots, dev)

        def altered(gen, args):
            rec = sample(gen, args).clone()
            rec[:, 72:144] ^= 1
            return rec
        return altered
    monkeypatch.setattr(pl, "build_record_sampler", build)


def _sector_swapped(monkeypatch):
    """The failures counted with the X logicals in place of the Z ones."""
    orig = StorageDecodePipeline.__post_init__

    def init(self):
        orig(self)
        self._Lz = torch.as_tensor(np.asarray(self.code.logicals.x, dtype=np.float32) % 2)
    monkeypatch.setattr(StorageDecodePipeline, "__post_init__", init)


FAULTS = [_altered_conv, _altered_correction, _half_relay, _half_batch, _altered_record,
          _sector_swapped]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_broken_relay_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    result = _run(RELAY)
    assert not result["correct"]
    assert [k for k, c in result["checks"].items() if c["value"] > c["limit"]], result["checks"]
