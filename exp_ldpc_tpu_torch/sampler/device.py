"""Pauli-frame sampler on a PyTorch device.

Counterpart of ``exp_ldpc_tpu/sampler/device.py`` with the semantics of
the CPU oracle ``sampler/reference.py::FrameSampler`` (see that module for
the frame algebra).  Noise probabilities are a device tensor
(``ParsedCircuit.noise_args()`` order), so rebinding a sweep point rebuilds
nothing.

On a CUDA device a batch is one launch of kernel K9 (``csrc/sampler.cu``):
the circuit is packed once into an op table (:func:`op_table`) that one
thread a shot walks in order, the REPEAT loop inside the kernel; each shot
draws from two Philox4x32-10 streams (noise words, frame bits) keyed by the
batch's ``torch.Generator`` (:func:`philox_start`: its seed and offset,
read and advanced on the host, no device sync).  A shot's frames live in
shared memory, or in device memory where one warp's do not fit a block's
(:func:`frame_plan`, by the qubit count).  ``KERNEL.launches`` counts one
launch a batch, and the counter ``sample_kernel`` one under ``ldpc.sample``.

On the CPU runs the plain version, :func:`_apply`: frames are (Q, S) uint8
bit planes with the shot axis last; every gate and noise channel of a
``ParsedCircuit`` op list is one or two indexed plane updates, and the
REPEAT body a Python loop over the same op tables; each channel draws
``torch.rand(..) < p`` exactly where the JAX sampler draws a Bernoulli.
The JAX sampler, K9 and the plain version give different bits from the same
seed; they agree in distribution.  The JAX sampler is XLA, with no Pallas
kernel, so K9 replaces none: it exists because the plain version, 3-15
PyTorch calls an op, is bound on the card by its host launches.
"""
from __future__ import annotations

import ctypes
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..circuits.ir import parse_circuit
from ..convert import DeviceOp, circuit_ops, noise_args
from ..utils.cuda_build import CudaKernel, device_limits
from ..utils.device import DeviceLike, resolve_device
from ..utils.observability import count, span

__all__ = ["build_record_sampler", "plain_record_sampler", "DeviceSampler", "KERNEL", "OPCODES",
           "OP_FIELDS", "CHUNK", "K9_THREADS", "MAX_QUBITS", "OpTable", "op_table",
           "fixed_calls", "FramePlan", "frame_plan", "philox_start"]

_P, _I, _U64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64
# csrc/sampler.cu::k9_sample: ops, data, args; n_pro, n_body, n_epi, repeat, pro_meas,
# body_meas, the prologue's and body's calls on streams 0 and 1, nw, S; seed, call0; route,
# blocks, threads, smem_bytes; frames, record, stream
KERNEL = CudaKernel("sampler.cu", "k9_sample", [_P] * 3 + [_I] * 12 + [_U64] * 2 + [_I] * 4
                    + [_P] * 3)
# csrc/sampler.cu::Opcode
OPCODES = {name: i for i, name in enumerate((
    "RZ", "RX", "MZ", "MX", "MRZ", "MRX", "CX", "CZ", "DEPOLARIZE1", "DEPOLARIZE2", "X_ERROR",
    "Y_ERROR", "Z_ERROR", "PAULI_CHANNEL_1", "PAULI_CHANNEL_2", "CORRELATED_ERROR",
    "ELSE_CORRELATED_ERROR"))}
_NAMES = {i: name for name, i in OPCODES.items()}
OP_FIELDS = 12      # csrc/sampler.cu::Field: a row of the op table (OpTable)
_F_NARGS, _F_NCH = 5, 7
CHUNK = 8           # csrc/sampler.cu::CH: targets (or edges) a chunk
K9_THREADS = 64     # csrc/sampler.cu::MAX_THREADS: threads a block
MAX_QUBITS = 32 << 24   # a chunk's frame word index has 24 bits
_ROUTES = {"shared": 0, "device": 1}
_CORRELATED = ("CORRELATED_ERROR", "ELSE_CORRELATED_ERROR")
_MEASURE = ("MZ", "MX", "MRZ", "MRX")


def _bern(p, shape, gen, dev) -> torch.Tensor:
    return (torch.rand(shape, generator=gen, device=dev) < p).to(torch.uint8)


def _rand_bits(shape, gen, dev) -> torch.Tensor:
    return torch.randint(0, 2, shape, generator=gen, device=dev, dtype=torch.uint8)


def _apply(op: DeviceOp, args, fx, fz, record, rec_base: int, chain, gen):
    """Apply one op to the frame planes in place; returns the chain plane."""
    S = fx.shape[1]
    dev = fx.device
    t = op.targets
    name = op.name
    if name in ("RZ", "MRZ"):
        if name == "MRZ":
            record[rec_base + op.meas_offset: rec_base + op.meas_offset + op.size] = \
                fx[t] ^ _bern(args[op.arg_index], (op.size, S), gen, dev) \
                if op.num_args else fx[t]
        fx[t] = 0
        fz[t] = _rand_bits((op.size, S), gen, dev)
    elif name in ("RX", "MRX"):
        if name == "MRX":
            record[rec_base + op.meas_offset: rec_base + op.meas_offset + op.size] = \
                fz[t] ^ _bern(args[op.arg_index], (op.size, S), gen, dev) \
                if op.num_args else fz[t]
        fz[t] = 0
        fx[t] = _rand_bits((op.size, S), gen, dev)
    elif name in ("MZ", "MX"):
        read, other = (fx, fz) if name == "MZ" else (fz, fx)
        out = read[t]
        if op.num_args:
            out = out ^ _bern(args[op.arg_index], (op.size, S), gen, dev)
        record[rec_base + op.meas_offset: rec_base + op.meas_offset + op.size] = out
        other[t] = _rand_bits((op.size, S), gen, dev)
    elif name == "CX":
        fx[op.b] ^= fx[op.a]
        fz[op.a] ^= fz[op.b]
    elif name == "CZ":
        za = fz[op.a] ^ fx[op.b]
        zb = fz[op.b] ^ fx[op.a]
        fz[op.a] = za
        fz[op.b] = zb
    elif name == "DEPOLARIZE1":
        e = _bern(args[op.arg_index], (op.size, S), gen, dev)
        k = torch.randint(1, 4, (op.size, S), generator=gen, device=dev, dtype=torch.uint8)
        fx[t] ^= e & (k & 1)
        fz[t] ^= e & ((k >> 1) & 1)
    elif name == "DEPOLARIZE2":
        npair = op.a.numel()
        e = _bern(args[op.arg_index], (npair, S), gen, dev)
        k = torch.randint(1, 16, (npair, S), generator=gen, device=dev, dtype=torch.uint8)
        fx[op.a] ^= e & (k & 1)
        fz[op.a] ^= e & ((k >> 1) & 1)
        fx[op.b] ^= e & ((k >> 2) & 1)
        fz[op.b] ^= e & ((k >> 3) & 1)
    elif name == "X_ERROR":
        fx[t] ^= _bern(args[op.arg_index], (op.size, S), gen, dev)
    elif name == "Z_ERROR":
        fz[t] ^= _bern(args[op.arg_index], (op.size, S), gen, dev)
    elif name == "Y_ERROR":
        e = _bern(args[op.arg_index], (op.size, S), gen, dev)
        fx[t] ^= e
        fz[t] ^= e
    elif name == "PAULI_CHANNEL_1":
        px, py, pz = (args[op.arg_index + j] for j in range(3))
        u = torch.rand((op.size, S), generator=gen, device=dev)
        fx[t] ^= (u < px + py).to(torch.uint8)
        fz[t] ^= ((u >= px) & (u < px + py + pz)).to(torch.uint8)
    elif name == "PAULI_CHANNEL_2":
        cum = torch.cumsum(args[op.arg_index: op.arg_index + 15], dim=0)
        u = torch.rand((op.a.numel(), S), generator=gen, device=dev)
        region = 1 + (u[None] >= cum[:, None, None]).sum(dim=0)
        pa, pb = region // 4, region % 4
        hit = region <= 15
        fx[op.a] ^= (hit & ((pa == 1) | (pa == 2))).to(torch.uint8)
        fz[op.a] ^= (hit & ((pa == 2) | (pa == 3))).to(torch.uint8)
        fx[op.b] ^= (hit & ((pb == 1) | (pb == 2))).to(torch.uint8)
        fz[op.b] ^= (hit & ((pb == 2) | (pb == 3))).to(torch.uint8)
    elif name in ("CORRELATED_ERROR", "ELSE_CORRELATED_ERROR"):
        draw = _bern(args[op.arg_index], (1, S), gen, dev)
        if name == "ELSE_CORRELATED_ERROR":
            fired = draw & (1 - chain)
            chain = chain | fired
        else:
            fired = draw
            chain = fired
        if op.x_targets.numel():
            fx[op.x_targets] ^= fired
        if op.z_targets.numel():
            fz[op.z_targets] ^= fired
    else:
        raise ValueError(f"unsupported op {name}")
    return chain


# ops that K9 runs in chunks of word slots (csrc/sampler.cu): a reset,
# measurement or single-qubit channel, and the two gates
_SINGLE = ("RZ", "RX") + _MEASURE + ("DEPOLARIZE1", "X_ERROR", "Y_ERROR", "Z_ERROR",
                                     "PAULI_CHANNEL_1")
# noise calls (4 words each) a chunk of a single-qubit channel makes on
# stream 0 (a noisy measurement's: 2)
_CHUNK_CALLS = {"DEPOLARIZE1": 4, "X_ERROR": 2, "Y_ERROR": 2, "Z_ERROR": 2,
                "PAULI_CHANNEL_1": 2}


def _runs(words: np.ndarray, qubits: Optional[np.ndarray] = None) -> List[Tuple[int, int]]:
    """[start, end) runs of equal consecutive ``words``, at most
    :data:`CHUNK` long, a run ending before a qubit of ``qubits`` it holds
    already."""
    out, start, seen = [], 0, set()
    for i in range(words.size + 1):
        if i > start and (i == words.size or words[i] != words[start] or i - start == CHUNK
                          or (qubits is not None and int(qubits[i]) in seen)):
            out.append((start, i))
            start, seen = i, set()
        if i < words.size and qubits is not None:
            seen.add(int(qubits[i]))
    return out


def _bytes(v: np.ndarray) -> Tuple[int, int]:
    """Up to 8 values below 256 as two words of 4 bytes each."""
    v = np.concatenate([v, np.zeros(CHUNK - v.size, dtype=np.int64)])
    return tuple(int(sum(int(x) << (8 * k) for k, x in enumerate(v[h: h + 4]))) for h in (0, 4))


def _single_chunks(t: np.ndarray) -> np.ndarray:
    """A single-qubit op's chunks, 4 words each: word | mask << 24, the 8
    bit positions as bytes (two words), the first target's index; no qubit
    twice in a chunk."""
    out = []
    for s, e in _runs(t >> 5, t):
        out.append((int(t[s] >> 5) | (((1 << (e - s)) - 1) << 24), *_bytes(t[s:e] & 31), s))
    return np.asarray(out, dtype=np.uint32).reshape(-1, 4)


def _edge_chunks(src: np.ndarray, dst: np.ndarray, commute: bool) -> np.ndarray:
    """A pass of edges (the dst bit ^= the src bit) as chunks of 12 words:
    dst word | mask << 24, the dst bit positions as bytes (two words), 0,
    the 8 source qubits (0 past the mask).  Where the edges commute they go
    by destination word, up to :data:`CHUNK` a chunk, else one a chunk in
    the circuit's order."""
    if commute:
        order = np.argsort(dst >> 5, kind="stable")
        src, dst = src[order], dst[order]
    out = []
    for s, e in _runs(dst >> 5) if commute else [(i, i + 1) for i in range(dst.size)]:
        srcs = np.concatenate([src[s:e], np.zeros(CHUNK - (e - s), dtype=np.int64)])
        out.append((int(dst[s] >> 5) | (((1 << (e - s)) - 1) << 24), *_bytes(dst[s:e] & 31), 0,
                    *(int(x) for x in srcs)))
    return np.asarray(out, dtype=np.uint32).reshape(-1, 12)


def _gate_passes(name: str, t: np.ndarray) -> List[np.ndarray]:
    """A CX's or CZ's passes of edges as chunks: CX X_a -> X_b then
    Z_b -> Z_a (each on its own plane), commuting where no qubit repeats;
    CZ X_b -> Z_a and X_a -> Z_b in one pass, which reads X and writes Z,
    so its edges always commute."""
    a, b = t[0::2].astype(np.int64), t[1::2].astype(np.int64)
    if name == "CX":
        distinct = np.unique(t).size == t.size
        return [_edge_chunks(a, b, distinct), _edge_chunks(b, a, distinct)]
    src = np.stack([b, a], 1).reshape(-1)
    dst = np.stack([a, b], 1).reshape(-1)
    return [_edge_chunks(src, dst, True)]


class OpTable(NamedTuple):
    """A ``ParsedCircuit`` as K9 reads it.  ``ops``: a row of
    :data:`OP_FIELDS` int32 a op, prologue, body and epilogue: opcode,
    targets, their offset in ``data``, first noise slot, first measurement
    within the block, noise slots, the offset of its chunks (or of E /
    ELSE's Pauli codes, 1 X 2 Y 3 Z), its chunks (a CX's X pass), a CX's Z
    pass's chunks, its first call on each stream within the block.
    ``data``: each op's targets (pairs interleaved), then its Pauli codes or
    chunks (:func:`_single_chunks`, :func:`_gate_passes`; 16-byte aligned).
    ``block_ops``, ``block_calls`` (stream 0, noise words) and
    ``block_bit_calls`` (stream 1, frame bits): each block's rows and
    calls; ``repeat``, the body's runs; ``word_calls`` and ``bit_calls``,
    the calls a shot makes on each stream."""

    ops: np.ndarray
    data: np.ndarray
    block_ops: Tuple[int, int, int]
    block_calls: Tuple[int, int, int]
    block_bit_calls: Tuple[int, int, int]
    repeat: int
    prologue_measurements: int
    body_measurements: int
    num_qubits: int
    num_measurements: int
    word_calls: int
    bit_calls: int

    @property
    def calls(self) -> int:
        """The calls a launch takes from the generator: the longer stream's."""
        return max(self.word_calls, self.bit_calls)


def op_table(parsed) -> OpTable:
    """Pack a ``ParsedCircuit`` for K9; noise slots are numbered in
    :meth:`noise_args` order, as :func:`convert.circuit_ops` numbers them."""
    c = parsed
    if c.num_qubits > MAX_QUBITS:
        raise ValueError(f"K9 takes at most {MAX_QUBITS} qubits (a chunk's word index has 24 "
                         f"bits), not {c.num_qubits}")
    rows, parts, calls_by_block, bits_by_block = [], [], [], []
    size = arg = 0
    repeat = c.repeat_count if c.body else 0

    def put(a: np.ndarray, align: int = 1) -> int:
        nonlocal size
        pad = -size % align
        if pad:
            parts.append(np.zeros(pad, dtype=np.uint32))
        parts.append(np.asarray(a, dtype=np.uint32).reshape(-1))
        size += pad + parts[-1].size
        return size - parts[-1].size

    for ops in (c.prologue, c.body, c.epilogue):
        calls = bit_calls = 0
        for op in ops:
            name = op.name
            if name not in OPCODES:
                raise ValueError(f"unsupported op {name}")
            t = np.asarray(op.targets, dtype=np.int64)
            k = int(op.num_noise_args)
            off = put(t)
            extra = nch = nch2 = 0
            call, bit_call = calls, bit_calls
            if name in _CORRELATED:
                extra = put(np.asarray(op.paulis))
                calls += 1
            elif name in ("CX", "CZ"):
                passes = _gate_passes(name, t)
                extra = put(np.concatenate(passes), 4)
                nch, nch2 = passes[0].shape[0], passes[1].shape[0] if name == "CX" else 0
            elif name in _SINGLE:
                chunks = _single_chunks(t)
                extra, nch = put(chunks, 4), chunks.shape[0]
                calls += nch * (_CHUNK_CALLS.get(name, 0) or (2 if k else 0))
                bit_calls += -(-nch // 16) if name in ("RZ", "RX") + _MEASURE else 0
            elif name == "DEPOLARIZE2":
                calls += -(-t.size // 4)
            elif name == "PAULI_CHANNEL_2":
                calls += -(-t.size // 8)
            rows.append((OPCODES[name], t.size, off, arg, int(op.meas_offset), k, extra, nch,
                         nch2, call, bit_call, 0))
            arg += k
        calls_by_block.append(calls)
        bits_by_block.append(bit_calls)
    data = np.concatenate(parts) if parts else np.zeros(0, dtype=np.uint32)
    (p0, b0, e0), (p1, b1, e1) = calls_by_block, bits_by_block
    return OpTable(np.asarray(rows, dtype=np.int32).reshape(-1, OP_FIELDS), data.view(np.int32),
                   (len(c.prologue), len(c.body), len(c.epilogue)), (p0, b0, e0), (p1, b1, e1),
                   repeat, c.prologue_measurements, c.body_measurements, c.num_qubits,
                   c.num_measurements, p0 + repeat * b0 + e0, p1 + repeat * b1 + e1)


def fixed_calls(table: OpTable) -> int:
    """The Philox calls every shot makes (both streams): the table's, less
    DEPOLARIZE1's Pauli calls, which a chunk makes only where it has an
    error (utils/bounds.py::sampler_bound's count)."""
    n_pro, n_body, _ = table.block_ops
    reps = np.full(table.ops.shape[0], 1)
    reps[n_pro: n_pro + n_body] = table.repeat
    dep1 = table.ops[:, 0] == OPCODES["DEPOLARIZE1"]
    return int(table.word_calls + table.bit_calls
               - (2 * table.ops[dep1, _F_NCH] * reps[dep1]).sum())


class FramePlan(NamedTuple):
    """A K9 launch: ``blocks`` blocks of ``threads`` threads, a thread a
    shot; each frame (X, Z) ``words`` 32-bit words.  Route "shared": the
    frames in ``smem_bytes`` of dynamic shared memory a block; "device": in
    ``frame_words`` words of device memory, laid (word, thread)."""

    route: str
    words: int
    threads: int
    blocks: int
    smem_bytes: int
    frame_words: int


def frame_plan(num_qubits: int, shots: int, smem_optin: int) -> FramePlan:
    """Route "shared" where one warp's frames (8 bytes a shot per 32
    qubits) fit ``smem_optin`` bytes (the card's opt-in shared memory a
    block), with :data:`K9_THREADS` threads a block or as many whole warps
    as fit; else route "device"."""
    if shots < 1:
        raise ValueError(f"shots ({shots}) must be positive")
    nw = max(1, -(-int(num_qubits) // 32))
    fit = 32 * (smem_optin // (32 * 8 * nw))
    if fit >= 32:
        threads = min(K9_THREADS, fit)
        return FramePlan("shared", nw, threads, -(-shots // threads), 8 * nw * threads, 0)
    blocks = -(-shots // K9_THREADS)
    return FramePlan("device", nw, K9_THREADS, blocks, 0, 2 * nw * blocks * K9_THREADS)


def philox_start(gen: torch.Generator, calls: int) -> Tuple[int, int]:
    """(key, first counter) of a K9 launch that makes ``calls`` Philox calls
    a shot: the generator's seed and its offset in 4-word calls, read on the
    host; the generator moves on past them, so the same seed gives the same
    record and two launches on one generator never share a draw."""
    offset = gen.get_offset()
    gen.set_offset(offset + 4 * calls)
    return gen.initial_seed(), offset // 4


def _kernel_sampler(c, S: int, dev: torch.device):
    """The K9 sampling function of :func:`build_record_sampler`."""
    table = op_table(c)
    n_args = int(table.ops[:, _F_NARGS].sum())
    ops = torch.as_tensor(table.ops.reshape(-1)).to(dev)
    data = torch.as_tensor(table.data if table.data.size
                           else np.zeros(1, dtype=np.int32)).to(dev)
    plan = frame_plan(c.num_qubits, S, device_limits(KERNEL, dev)[0])
    n_pro, n_body, n_epi = table.block_ops
    M = table.num_measurements

    def sample(gen: torch.Generator, args: torch.Tensor) -> torch.Tensor:
        with span("sample"):
            if (args.device.type != "cuda" or args.dtype != torch.float32
                    or args.dim() != 1 or args.numel() < n_args or not args.is_contiguous()):
                raise ValueError(f"K9 takes the noise as a contiguous float32 CUDA vector of "
                                 f"{n_args} slots, not {args.dtype} {tuple(args.shape)} on "
                                 f"{args.device}")
            if gen.device.type != "cuda":
                raise ValueError(f"K9 draws from a CUDA generator, not one on {gen.device}")
            record = torch.empty((M, S), dtype=torch.uint8, device=dev)
            seed, call0 = philox_start(gen, table.calls)
            frames = (torch.empty(plan.frame_words, dtype=torch.int32, device=dev)
                      if plan.route == "device" else None)
            KERNEL.launch(ops.data_ptr(), data.data_ptr(), args.data_ptr(), n_pro, n_body,
                          n_epi, table.repeat, table.prologue_measurements,
                          table.body_measurements, table.block_calls[0], table.block_calls[1],
                          table.block_bit_calls[0], table.block_bit_calls[1], plan.words, S, seed,
                          call0, _ROUTES[plan.route], plan.blocks, plan.threads, plan.smem_bytes,
                          None if frames is None else frames.data_ptr(), record.data_ptr(),
                          torch.cuda.current_stream(dev).cuda_stream, route=plan.route)
            count("sample_kernel", 1)
            return record.T

    return sample


def build_record_sampler(circuit, shots: int, device: DeviceLike = "cuda"
                         ) -> Callable[[torch.Generator, torch.Tensor], torch.Tensor]:
    """Sampling function for a fixed circuit STRUCTURE:
    ``(generator, noise_args) -> (shots, M) uint8 record`` on ``device``,
    where ``noise_args`` is the f32 vector of :func:`convert.noise_args`.
    Record layout as the JAX sampler: rounds of [x_checks..., z_checks...]
    then the data readout.  On a CUDA device every call is one K9 launch;
    on the CPU the plain version runs (:func:`plain_record_sampler`)."""
    c = circuit if hasattr(circuit, "prologue") else parse_circuit(circuit)
    dev = resolve_device(device)
    if dev.type == "cuda":
        return _kernel_sampler(c, int(shots), dev)
    return plain_record_sampler(c, shots, dev)


def plain_record_sampler(circuit, shots: int, device: DeviceLike = "cpu"
                         ) -> Callable[[torch.Generator, torch.Tensor], torch.Tensor]:
    """K9's plain version, :func:`build_record_sampler`'s function on the
    CPU: :func:`_apply` op by op, the REPEAT body a Python loop (on a card
    only to be timed beside K9)."""
    c = circuit if hasattr(circuit, "prologue") else parse_circuit(circuit)
    dev = resolve_device(device)
    S = int(shots)
    n_pro = sum(op.num_noise_args for op in c.prologue)
    n_body = sum(op.num_noise_args for op in c.body)
    pro = circuit_ops(c.prologue, dev, 0)
    body = circuit_ops(c.body, dev, n_pro)
    epi = circuit_ops(c.epilogue, dev, n_pro + n_body)
    Q, M = c.num_qubits, c.num_measurements

    def run_block(ops: List[DeviceOp], args, fx, fz, record, base, gen):
        chain = torch.zeros((1, S), dtype=torch.uint8, device=dev)
        for op in ops:
            chain = _apply(op, args, fx, fz, record, base, chain, gen)

    def sample(gen: torch.Generator, args: torch.Tensor) -> torch.Tensor:
        with span("sample"):
            fx = torch.zeros((Q, S), dtype=torch.uint8, device=dev)
            fz = torch.zeros((Q, S), dtype=torch.uint8, device=dev)
            record = torch.zeros((M, S), dtype=torch.uint8, device=dev)
            run_block(pro, args, fx, fz, record, 0, gen)
            for it in range(c.repeat_count if c.body else 0):
                base = c.prologue_measurements + it * c.body_measurements
                run_block(body, args, fx, fz, record, base, gen)
            epi_base = c.prologue_measurements + c.repeat_count * c.body_measurements
            run_block(epi, args, fx, fz, record, epi_base, gen)
            return record.T

    return sample


class DeviceSampler:
    """Batch sampler for a fixed circuit and shot count on one device."""

    def __init__(self, circuit, shots: int, device: DeviceLike = "cuda"):
        c = circuit if hasattr(circuit, "prologue") else parse_circuit(circuit)
        self.circuit = c
        self.shots = int(shots)
        self.device = resolve_device(device)
        self._sample = build_record_sampler(c, self.shots, self.device)
        self._noise_args = noise_args(c, self.device)
        self._det = self._obs = None   # dense (records x detectors), made at first use

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        """uint8 (shots, num_measurements) measurement record."""
        return self._sample(generator, self._noise_args)

    def sample_detectors(self, generator: torch.Generator,
                         append_observables: bool = False) -> torch.Tensor:
        if self._det is None:
            c = self.circuit
            self._det, self._obs = (
                torch.as_tensor(m.toarray().T.astype(np.float32)).to(self.device)
                for m in (c.detector_matrix(), c.observable_matrix()))
        record = self.sample(generator).to(torch.float32)
        det = torch.remainder(record @ self._det, 2.0).to(torch.uint8)
        if append_observables:
            obs = torch.remainder(record @ self._obs, 2.0).to(torch.uint8)
            det = torch.cat([det, obs], dim=1)
        return det
