"""Port: the device Pauli-frame sampler (exp_ldpc_tpu_torch/sampler/
device.py) on the CPU.  Deterministic hand cases must hold exactly;
random circuits agree with the host oracle ``FrameSampler`` in
distribution (per-bit rates within 5 sigma of a two-sample test), since
torch.Generator and numpy draw different bits from the same seed."""
import numpy as np
import pytest
import torch

from exp_ldpc_tpu.circuits.noise import depolarizing_noise, trivial_noise
from exp_ldpc_tpu.circuits.storage_sim import build_storage_simulation
from exp_ldpc_tpu.codes.hgp import biregular_hgp
from exp_ldpc_tpu.sampler.reference import FrameSampler
from exp_ldpc_tpu_torch.sampler.device import DeviceSampler, build_record_sampler

MIXED = """
R 0 1 2 3 4 5
RX 6
TICK
REPEAT 3 {
  DEPOLARIZE1(0.05) 0 1 2
  CX 0 3 1 4
  TICK
  CZ 2 5 6 0
  DEPOLARIZE2(0.08) 1 2
  TICK
  X_ERROR(0.1) 3
  Y_ERROR(0.07) 4
  Z_ERROR(0.2) 6
  PAULI_CHANNEL_1(0.03, 0.05, 0.07) 5
  TICK
  PAULI_CHANNEL_2(0.01, 0.02, 0.01, 0.02, 0.01, 0.02, 0.01, 0.02, 0.01, 0.02, 0.01, 0.02, 0.01, 0.02, 0.03) 0 5
  E(0.1) X1 Z2
  ELSE_CORRELATED_ERROR(0.3) Y3
  TICK
  MR(0.02) 3 4
  MX(0.01) 6
  DETECTOR rec[-1]
  DETECTOR rec[-2] rec[-3]
}
M(0.01) 0 1 2 5
MRX 6
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once; torch's default of one
    thread per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _rates_agree(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|z| of a pooled two-proportion test per column of two 0/1 samples."""
    ra, rb = a.mean(axis=0), b.mean(axis=0)
    pool = (ra * len(a) + rb * len(b)) / (len(a) + len(b))
    sigma = np.sqrt(pool * (1 - pool) * (1 / len(a) + 1 / len(b)))
    return np.abs(ra - rb) / np.where(sigma > 0, sigma, 1.0)


@pytest.fixture(scope="module")
def small_code():
    return biregular_hgp(6, 2, 3, seed=1, compute_logicals=True)


def test_noiseless_storage_circuit_has_zero_detectors(small_code):
    sim = build_storage_simulation(3, trivial_noise(), small_code)
    det = DeviceSampler(sim.circuit, 512, "cpu").sample_detectors(_gen(1),
                                                                  append_observables=True)
    assert det.shape[1] > 0
    assert int(det.sum()) == 0


def test_certain_errors_flip_exactly_those_bits():
    circ = "R 0 1 2 3\nRX 4 5\nX_ERROR(1) 1 3\nZ_ERROR(1) 5\nM 0 1 2 3\nMX 4 5\nMR 1\nM 1"
    rec = DeviceSampler(circ, 64, "cpu").sample(_gen(2)).numpy()
    np.testing.assert_array_equal(rec, np.tile([0, 1, 0, 1, 0, 1, 1, 0], (64, 1)))


def test_measurement_flip_probability_one():
    rec = DeviceSampler("R 0 1\nM(1) 0\nM 1", 32, "cpu").sample(_gen(3)).numpy()
    np.testing.assert_array_equal(rec, np.tile([1, 0], (32, 1)))


def test_record_sampler_function_matches_class():
    """build_record_sampler is the same sampling program as DeviceSampler."""
    from exp_ldpc_tpu_torch.convert import noise_args
    from exp_ldpc_tpu_torch.circuits.ir import parse_circuit

    parsed = parse_circuit(MIXED)
    fn = build_record_sampler(parsed, 256, "cpu")
    a = fn(_gen(4), noise_args(parsed, "cpu"))
    b = DeviceSampler(parsed, 256, "cpu").sample(_gen(4))
    assert torch.equal(a, b)
    assert a.shape == (256, parsed.num_measurements)


def test_noise_is_a_runtime_argument():
    """One sampling program serves every noise value of a structure: the
    probabilities are read from the tensor passed at call time."""
    from exp_ldpc_tpu_torch.circuits.ir import parse_circuit

    program = build_record_sampler(parse_circuit("R 0 1\nX_ERROR(0.5) 0 1\nM 0 1"), 64, "cpu")
    for p in (0.0, 1.0):
        rec = program(_gen(11), torch.tensor([p, p], dtype=torch.float32))
        assert torch.equal(rec, torch.full((64, 2), int(p), dtype=torch.uint8))


def test_mixed_circuit_matches_frame_sampler():
    """Every channel kind (incl. REPEAT, CZ, Pauli channels, correlated
    chains, MR/MX) against the oracle, per measurement and per detector."""
    n_dev, n_host = 20000, 20000
    ds = DeviceSampler(MIXED, n_dev, "cpu")
    rec_d = ds.sample(_gen(5)).numpy()
    rec_h = FrameSampler(MIXED, seed=6).sample(n_host)
    z = _rates_agree(rec_d, rec_h)
    assert z.max() <= 5.0, z
    det_d = ds.sample_detectors(_gen(7), append_observables=False).numpy()
    det_h = FrameSampler(MIXED, seed=8).sample_detectors(n_host)
    assert _rates_agree(det_d, det_h).max() <= 5.0


def test_storage_detector_rates_match_frame_sampler(small_code):
    p = 0.01
    sim = build_storage_simulation(3, depolarizing_noise(p, p), small_code)
    det_d = DeviceSampler(sim.circuit, 8192, "cpu").sample_detectors(
        _gen(9), append_observables=True).numpy()
    det_h = FrameSampler(sim.circuit, seed=10).sample_detectors(8192, append_observables=True)
    assert det_d.mean() > 0.005
    assert _rates_agree(det_d, det_h).max() <= 5.0
