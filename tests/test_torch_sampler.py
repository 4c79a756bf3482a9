"""Port: the device Pauli-frame sampler (exp_ldpc_tpu_torch/sampler/
device.py): the plain version on the CPU and, marked ``gpu``, kernel K9 on
a card.  Deterministic hand cases must hold exactly; random circuits agree
with the host oracle ``FrameSampler`` in distribution (per-bit rates within
5 sigma of a two-sample test), since torch.Generator, K9's Philox stream and
numpy draw different bits from the same seed.

K9 is held bit for bit to ``sampler/replay.py::replay``, a numpy replay of
its op table and Philox4x32-10 streams (``csrc/sampler.cu`` states the
draws); on the CPU the replay's Philox is held to Random123's known answers,
the replay to ``FrameSampler`` in distribution, and the packed table to the
circuit's ops.
The file imports the port alone (its copies of the circuit, code and oracle
modules), so that on a machine with a card ``python -m pytest --noconftest
-m gpu tests/test_torch_sampler.py`` runs it there."""
import dataclasses

import numpy as np
import pytest
import torch

from exp_ldpc_tpu_torch.circuits.ir import parse_circuit
from exp_ldpc_tpu_torch.circuits.noise import depolarizing_noise, trivial_noise
from exp_ldpc_tpu_torch.circuits.storage_sim import build_storage_simulation
from exp_ldpc_tpu_torch.codes.hgp import biregular_hgp
from exp_ldpc_tpu_torch.convert import noise_args
from exp_ldpc_tpu_torch.sampler import device as sd
from exp_ldpc_tpu_torch.sampler.device import DeviceSampler, build_record_sampler
from exp_ldpc_tpu_torch.sampler.replay import (chunk_targets, pass_edges, philox4x32_10, replay,
                                               shift_qubits, table_ops)
from exp_ldpc_tpu_torch.sampler.reference import FrameSampler

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
# ops whose qubits repeat: K9 runs them target by target (no read hoisted
# over an earlier target's write), as the replay does
REPEATED = """
R 0 1 2 3
RX 4
X_ERROR(0.3) 0 0 1
CX 0 1 1 2 4 3
CZ 0 1 0 2
M(0.1) 0 0 1
MR(0.05) 1 1 2
MX 4 4
MRX(0.2) 4 3 4
DEPOLARIZE1(0.3) 0 0 3
M 0 1 2 3 4
"""
H100_SMEM = 232448   # an H100's opt-in shared memory a block
BIG_SEED = 2**62 + 12345   # the benchmark's seeds are 63-bit


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once; torch's default of one
    thread per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)]


@pytest.fixture(params=DEVICES)
def dev(request):
    """The sampler's device: the plain version on the CPU, K9 on a card."""
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K9 runs on the card only)")
    return torch.device(request.param)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K9 runs on the card only)")
    return torch.device("cuda")


def _gen(seed, device="cpu"):
    g = torch.Generator(device=device)
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


def test_noiseless_storage_circuit_has_zero_detectors(small_code, dev):
    sim = build_storage_simulation(3, trivial_noise(), small_code)
    det = DeviceSampler(sim.circuit, 512, dev).sample_detectors(_gen(1, dev),
                                                                append_observables=True)
    assert det.shape[1] > 0
    assert int(det.sum()) == 0


def test_certain_errors_flip_exactly_those_bits(dev):
    circ = "R 0 1 2 3\nRX 4 5\nX_ERROR(1) 1 3\nZ_ERROR(1) 5\nM 0 1 2 3\nMX 4 5\nMR 1\nM 1"
    rec = DeviceSampler(circ, 64, dev).sample(_gen(2, dev)).cpu().numpy()
    np.testing.assert_array_equal(rec, np.tile([0, 1, 0, 1, 0, 1, 1, 0], (64, 1)))


def test_measurement_flip_probability_one(dev):
    rec = DeviceSampler("R 0 1\nM(1) 0\nM 1", 32, dev).sample(_gen(3, dev)).cpu().numpy()
    np.testing.assert_array_equal(rec, np.tile([1, 0], (32, 1)))


def test_record_sampler_function_matches_class(dev):
    """build_record_sampler is the same sampling program as DeviceSampler."""
    parsed = parse_circuit(MIXED)
    fn = build_record_sampler(parsed, 256, dev)
    a = fn(_gen(4, dev), noise_args(parsed, dev))
    b = DeviceSampler(parsed, 256, dev).sample(_gen(4, dev))
    assert torch.equal(a, b)
    assert a.shape == (256, parsed.num_measurements)


def test_noise_is_a_runtime_argument(dev):
    """One sampling program serves every noise value of a structure: the
    probabilities are read from the tensor passed at call time."""
    program = build_record_sampler(parse_circuit("R 0 1\nX_ERROR(0.5) 0 1\nM 0 1"), 64, dev)
    for p in (0.0, 1.0):
        rec = program(_gen(11, dev), torch.tensor([p, p], dtype=torch.float32, device=dev))
        assert torch.equal(rec.cpu(), torch.full((64, 2), int(p), dtype=torch.uint8))


def test_mixed_circuit_matches_frame_sampler(dev):
    """Every channel kind (incl. REPEAT, CZ, Pauli channels, correlated
    chains, MR/MX) against the oracle, per measurement and per detector."""
    n_dev, n_host = 20000, 20000
    ds = DeviceSampler(MIXED, n_dev, dev)
    rec_d = ds.sample(_gen(5, dev)).cpu().numpy()
    rec_h = FrameSampler(MIXED, seed=6).sample(n_host)
    z = _rates_agree(rec_d, rec_h)
    assert z.max() <= 5.0, z
    det_d = ds.sample_detectors(_gen(7, dev), append_observables=False).cpu().numpy()
    det_h = FrameSampler(MIXED, seed=8).sample_detectors(n_host)
    assert _rates_agree(det_d, det_h).max() <= 5.0


def test_storage_detector_rates_match_frame_sampler(small_code, dev):
    p = 0.01
    sim = build_storage_simulation(3, depolarizing_noise(p, p), small_code)
    det_d = DeviceSampler(sim.circuit, 8192, dev).sample_detectors(
        _gen(9, dev), append_observables=True).cpu().numpy()
    det_h = FrameSampler(sim.circuit, seed=10).sample_detectors(8192, append_observables=True)
    assert det_d.mean() > 0.005
    assert _rates_agree(det_d, det_h).max() <= 5.0


# ------------------------------------------------ K9's op table and its replay

@pytest.mark.parametrize("ctr, key, want", [
    # Random123's known answers for philox4x32_10
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_replay_philox_known_answers(ctr, key, want):
    got = philox4x32_10([np.array([c], dtype=np.uint64) for c in ctr], key)
    assert tuple(int(w[0]) for w in got) == want


@pytest.mark.parametrize("text", [MIXED, "storage"])
def test_op_table_round_trips_the_circuit(text, small_code):
    """The packed table reads back to the ParsedCircuit's ops: names,
    targets (pairs interleaved), Pauli codes of E / ELSE, noise slots in
    ``noise_args`` order, measurement offsets; and its word count is what
    the replay draws."""
    if text == "storage":
        text = build_storage_simulation(3, depolarizing_noise(0.01, 0.01), small_code).circuit
    parsed = parse_circuit(text)
    table = sd.op_table(parsed)
    assert table.ops.dtype == np.int32 and table.ops.shape[1] == sd.OP_FIELDS
    assert table.repeat == parsed.repeat_count
    assert table.num_measurements == parsed.num_measurements
    arg = 0
    for block, ops in zip(table_ops(table), (parsed.prologue, parsed.body, parsed.epilogue)):
        assert len(block) == len(ops)
        for (name, targets, paulis, k, a, meas), op in zip(block, ops):
            assert name == op.name
            np.testing.assert_array_equal(targets, op.targets)
            if op.paulis is None:
                assert paulis is None
            else:
                np.testing.assert_array_equal(paulis, op.paulis)
            assert (k, a, meas) == (op.num_noise_args, arg, op.meas_offset)
            arg += k
    assert arg == parsed.noise_args().size
    _rec, calls = replay(table, parsed.noise_args(), 7, 0, 4)
    assert calls == (table.word_calls, table.bit_calls)


@pytest.mark.parametrize("text", [MIXED, REPEATED, "storage"])
def test_chunks_cover_the_targets_in_order(text, small_code):
    """A single-qubit op's chunks hold its targets in order, up to 8 in one
    frame word each, no qubit twice; a gate's passes hold its edges, up to 8 with one
    destination word a chunk, sorted by that word only where they commute
    (CZ; CX where no qubit repeats), else one a chunk in the circuit's
    order."""
    if text == "storage":
        text = build_storage_simulation(2, depolarizing_noise(0.01, 0.01), small_code).circuit
    parsed = parse_circuit(text)
    table = sd.op_table(parsed)
    ops = [op for block in (parsed.prologue, parsed.body, parsed.epilogue) for op in block]
    for op, (code, n, _o, _a, _m, _k, extra, nch, nch2, *_) in zip(ops, table.ops.tolist()):
        t = [int(q) for q in op.targets]
        if op.name in sd._SINGLE:
            chunks = chunk_targets(table, extra, nch)
            assert [q for *tg, _ in chunks for _j, q in tg] == t
            assert [i0 for *_, i0 in chunks] == np.cumsum([0] + [len(c) - 1
                                                                for c in chunks[:-1]]).tolist()
            assert all(len({q >> 5 for _j, q in tg}) == 1 and len(tg) <= 8
                       and len({q for _j, q in tg}) == len(tg) for *tg, _ in chunks)
        elif op.name in ("CX", "CZ"):
            a, b = t[0::2], t[1::2]
            want = ([list(zip(a, b)), list(zip(b, a))] if op.name == "CX"
                    else [[e for pair in zip(zip(b, a), zip(a, b)) for e in pair]])
            got = [pass_edges(table, extra, nch)] + ([pass_edges(table, extra + 12 * nch, nch2)]
                                                 if op.name == "CX" else [])
            commute = op.name == "CZ" or len(set(t)) == len(t)
            for g, w in zip(got, want):
                if commute:
                    assert sorted(g) == sorted(w)
                    assert [d >> 5 for _s, d in g] == sorted(d >> 5 for _s, d in g)
                else:
                    assert g == w


@pytest.mark.parametrize("text", [MIXED, REPEATED, "storage"])
def test_gate_edges_compute_the_gates(text, small_code):
    """A CX's or CZ's passes of edges (the dst bit ^= the src bit, in the
    table's order) do what its gates do in the circuit's order, on random
    frames: sorting a pass by destination word keeps the result."""
    if text == "storage":
        text = build_storage_simulation(2, depolarizing_noise(0.01, 0.01), small_code).circuit
    parsed = parse_circuit(text)
    table = sd.op_table(parsed)
    rng = np.random.default_rng(3)
    ops = [op for block in (parsed.prologue, parsed.body, parsed.epilogue) for op in block]
    checked = 0
    for op, (code, n, _o, _a, _m, _k, extra, nch, nch2, *_) in zip(ops, table.ops.tolist()):
        if op.name not in ("CX", "CZ"):
            continue
        want = rng.integers(0, 2, (2, parsed.num_qubits)).astype(np.uint8)
        got = want.copy()
        for a, b in zip(op.targets[0::2], op.targets[1::2]):
            if op.name == "CX":
                want[0, b] ^= want[0, a]
                want[1, a] ^= want[1, b]
            else:
                xa, xb = want[0, a], want[0, b]
                want[1, a] ^= xb
                want[1, b] ^= xa
        passes = ([(extra, nch, 0, 0), (extra + 12 * nch, nch2, 1, 1)] if op.name == "CX"
                  else [(extra, nch, 0, 1)])
        for e_off, e_n, sp, dp in passes:
            for src, dst in pass_edges(table, e_off, e_n):
                got[dp, dst] ^= got[sp, src]
        np.testing.assert_array_equal(got, want)
        checked += 1
    assert checked > 0


def test_op_table_refuses_an_unknown_op():
    parsed = parse_circuit("R 0\nM 0")
    parsed.prologue[0] = dataclasses.replace(parsed.prologue[0], name="H")
    with pytest.raises(ValueError, match="unsupported op H"):
        sd.op_table(parsed)


def test_op_table_refuses_qubits_past_its_word_index():
    """A chunk holds its frame word's index in 24 bits."""
    parsed = parse_circuit("R 0\nM 0")
    assert sd.op_table(dataclasses.replace(parsed, num_qubits=sd.MAX_QUBITS)).ops.shape[0] == 2
    with pytest.raises(ValueError, match="at most"):
        sd.op_table(dataclasses.replace(parsed, num_qubits=sd.MAX_QUBITS + 1))


@pytest.mark.parametrize("qubits, shots, want", [
    (441, 16384, ("shared", 14, 64, 256, 7168, 0)),    # HGP-225 x 4 rounds
    (288, 20000, ("shared", 9, 64, 313, 4608, 0)),     # the gross code
    (29056, 100, ("shared", 908, 32, 4, 232448, 0)),   # one warp's frames fill a block
    (29057, 100, ("device", 909, 64, 2, 0, 2 * 909 * 128)),
])
def test_frame_plan(qubits, shots, want):
    assert tuple(sd.frame_plan(qubits, shots, H100_SMEM)) == want


def test_replay_matches_frame_sampler():
    """K9's draws (Bernoulli thresholds, uniform Paulis, frame bits, the E /
    ELSE chain) sample the oracle's distribution: the replay against
    FrameSampler on every channel kind."""
    parsed = parse_circuit(MIXED)
    rec, _ = replay(sd.op_table(parsed), parsed.noise_args(), BIG_SEED, 3, 20000)
    z = _rates_agree(rec.T, FrameSampler(MIXED, seed=12).sample(20000))
    assert z.max() <= 5.0, z


class _OffsetGenerator:
    """The part of a CUDA ``torch.Generator`` K9 reads (a CPU generator has
    no offset)."""

    def __init__(self, seed):
        self.seed, self.offset = seed, 0

    def initial_seed(self):
        return self.seed

    def get_offset(self):
        return self.offset

    def set_offset(self, offset):
        assert offset % 4 == 0
        self.offset = offset


def test_shifted_qubits_draw_the_same_record():
    """Shifting every qubit by whole words keeps the chunks and the draws:
    the replay's record is the same (the device-route check relies on it)."""
    parsed = parse_circuit(MIXED)
    wide = shift_qubits(parsed, 1000)
    assert sd.frame_plan(wide.num_qubits, 64, H100_SMEM).route == "device"
    a, _ = replay(sd.op_table(parsed), parsed.noise_args(), BIG_SEED, 5, 64)
    b, _ = replay(sd.op_table(wide), wide.noise_args(), BIG_SEED, 5, 64)
    np.testing.assert_array_equal(a, b)


def test_sampler_bound_counts_the_fixed_calls_and_the_record(small_code):
    """K9's bound: the Philox calls every shot makes (DEPOLARIZE1's Pauli
    calls, made only where a chunk has an error, left out) at PHILOX_OPS
    integer operations each over the card's int32 rate, or the record's
    bytes over the device-memory rate."""
    from exp_ldpc_tpu_torch.utils.bounds import (HBM_BYTES_PER_S, INT32_OPS_PER_S, PHILOX_OPS,
                                                 sampler_bound)

    parsed = parse_circuit(build_storage_simulation(
        3, depolarizing_noise(0.01, 0.01), small_code).circuit)
    table = sd.op_table(parsed)
    dep1 = sum(2 * nch * (table.repeat if table.block_ops[0] <= i < sum(table.block_ops[:2])
                          else 1)
               for i, (code, nch) in enumerate(table.ops[:, [0, 7]].tolist())
               if sd._NAMES[code] == "DEPOLARIZE1")
    assert dep1 > 0
    assert sd.fixed_calls(table) == table.word_calls + table.bit_calls - dep1
    b = sampler_bound(sd.fixed_calls(table), 1000, parsed.num_measurements)
    assert b["bound_ops"] == PHILOX_OPS * sd.fixed_calls(table) * 1000 and PHILOX_OPS == 60
    assert b["bound_bytes"] == parsed.num_measurements * 1000
    assert b["bound_ms"] == pytest.approx(max(1e3 * b["bound_ops"] / INT32_OPS_PER_S,
                                              1e3 * b["bound_bytes"] / HBM_BYTES_PER_S))


def test_philox_start_advances_the_generator():
    """A launch reads the seed and the offset (in 4-word calls) and moves
    the offset past its calls."""
    g = _OffsetGenerator(BIG_SEED)
    assert sd.philox_start(g, 10) == (BIG_SEED, 0)
    assert sd.philox_start(g, 3) == (BIG_SEED, 10)
    assert g.get_offset() == 52


# ------------------------------------------------------------- K9 on the card


def _k9(parsed, shots, dev, seed):
    """(K9's (M, shots) record, its key and first counter) for one seed."""
    gen = _gen(seed, dev)
    seed_, call0 = gen.initial_seed(), gen.get_offset() // 4
    rec = build_record_sampler(parsed, shots, dev)(gen, noise_args(parsed, dev))
    return rec.T.cpu().numpy(), seed_, call0


@pytest.mark.gpu
def test_k9_equals_its_replay_bit_for_bit(card):
    """Every op kind (MIXED): K9's record is the replay's, bit for bit."""
    parsed = parse_circuit(MIXED)
    sd.KERNEL.reset_counts()
    rec, seed, call0 = _k9(parsed, 4099, card, BIG_SEED)
    want, _ = replay(sd.op_table(parsed), parsed.noise_args(), seed, call0, 4099)
    np.testing.assert_array_equal(rec, want)
    assert sd.KERNEL.launches == 1 and sd.KERNEL.routes == {"shared": 1}


@pytest.mark.gpu
def test_k9_repeated_qubits_equal_the_replay(card):
    """Ops whose qubits repeat run target by target on the card too."""
    parsed = parse_circuit(REPEATED)
    rec, seed, call0 = _k9(parsed, 333, card, 5)
    want, _ = replay(sd.op_table(parsed), parsed.noise_args(), seed, call0, 333)
    np.testing.assert_array_equal(rec, want)


@pytest.mark.gpu
def test_k9_seed_repeats_and_calls_differ(card):
    """The same seed gives the same record; two calls on one generator
    give different records (the second starts past the first's words)."""
    parsed = parse_circuit(MIXED)
    fn = build_record_sampler(parsed, 2048, card)
    args = noise_args(parsed, card)
    a = fn(_gen(BIG_SEED, card), args)
    b = fn(_gen(BIG_SEED, card), args)
    assert torch.equal(a, b)
    g = _gen(BIG_SEED, card)
    first, second = fn(g, args), fn(g, args)
    assert torch.equal(first, a)
    assert not torch.equal(first, second)
    table = sd.op_table(parsed)
    want, _ = replay(table, parsed.noise_args(), BIG_SEED, table.calls, 2048)
    np.testing.assert_array_equal(second.T.cpu().numpy(), want)


@pytest.mark.gpu
def test_k9_both_frame_routes(card):
    """Route "shared" on MIXED, route "device" on MIXED with its qubits
    shifted past a block's shared memory: each equals the replay, and the
    two records are one (the shift moves no draw)."""
    parsed = parse_circuit(MIXED)
    wide = shift_qubits(parsed, 1000)
    smem, _ = sd.device_limits(sd.KERNEL, card)
    assert sd.frame_plan(parsed.num_qubits, 1000, smem).route == "shared"
    assert sd.frame_plan(wide.num_qubits, 1000, smem).route == "device"
    sd.KERNEL.reset_counts()
    small, seed, call0 = _k9(parsed, 1000, card, 99)
    big, _, _ = _k9(wide, 1000, card, 99)
    assert sd.KERNEL.routes == {"shared": 1, "device": 1}
    want, _ = replay(sd.op_table(wide), wide.noise_args(), seed, call0, 1000)
    np.testing.assert_array_equal(big, want)
    np.testing.assert_array_equal(small, want)


@pytest.mark.gpu
def test_k9_refuses_what_it_does_not_take(card):
    fn = build_record_sampler(parse_circuit("R 0\nX_ERROR(0.1) 0\nM 0"), 64, card)
    with pytest.raises(ValueError, match="CUDA generator"):
        fn(_gen(1), torch.tensor([0.1], device=card))
    with pytest.raises(ValueError, match="float32 CUDA vector"):
        fn(_gen(1, card), torch.tensor([0.1]))
