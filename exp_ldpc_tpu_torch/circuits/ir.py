"""Structured circuit IR parsed from Stim-format text.

The reference delegates circuit execution to the external Stim C++ sampler
(``reference/python/qldpc/misc/_experiment.py:172,193-197``).  Here the
text format stays the interchange surface, but execution is native: this
parser compiles the text into a flat, statically-shaped op list that both the
CPU oracle sampler (:mod:`exp_ldpc_tpu.sampler.reference`) and the JAX/TPU
sampler (:mod:`exp_ldpc_tpu.sampler.device`) consume.

Compilation choices are TPU-driven:
  * REPEAT blocks are recorded structurally (prologue / body x count /
    epilogue) so the device sampler can lower them to ``lax.scan`` instead of
    unrolling the trace;
  * adjacent one-line gates of the same kind inside a tick are fused into a
    single op with an index *array* (one gather/scatter per layer, not per
    gate);
  * DETECTOR / OBSERVABLE_INCLUDE lines are resolved to absolute measurement
    indices and materialized as a sparse detector matrix, so detector
    sampling is a single bit-matmul on the record.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy import sparse

__all__ = ["Op", "ParsedCircuit", "parse_circuit"]

_LINE_RE = re.compile(r"^\s*([A-Za-z_][A-Za-z0-9_]*)(?:\(([^)]*)\))?\s*(.*?)\s*$")
_REC_RE = re.compile(r"rec\[(-\d+)\]")

# canonical op names
_ALIASES = {
    "R": "RZ",
    "M": "MZ",
    "MR": "MRZ",
    "CNOT": "CX",
    "E": "CORRELATED_ERROR",
}
GATES_1Q_RESET = {"RX", "RZ"}
GATES_1Q_MEAS = {"MX", "MZ"}
GATES_1Q_MEAS_RESET = {"MRX", "MRZ"}
GATES_2Q = {"CX", "CZ"}
NOISE_1Q = {"DEPOLARIZE1", "X_ERROR", "Y_ERROR", "Z_ERROR"}
NOISE_2Q = {"DEPOLARIZE2"}
# multi-parameter Pauli channels: one Pauli drawn from DISJOINT per-Pauli
# probabilities (Stim semantics).  Parameter counts are fixed by the channel.
NOISE_MULTI_ARG = {"PAULI_CHANNEL_1": 3, "PAULI_CHANNEL_2": 15}
# correlated Pauli-product channels (stim semantics, reference vocabulary at
# ``storage_sim.py:77-87``): CORRELATED_ERROR(p) applies its whole Pauli
# product with probability p and starts a chain; each following
# ELSE_CORRELATED_ERROR(p) applies its product with probability p ONLY if
# nothing earlier in the chain fired.  Targets are Pauli targets (X1 Y2 Z3).
# Never fused: chain adjacency is semantic.
NOISE_CORRELATED = {"CORRELATED_ERROR", "ELSE_CORRELATED_ERROR"}
FUSABLE = GATES_2Q | NOISE_1Q | NOISE_2Q | set(NOISE_MULTI_ARG)
_PAULI_TARGET_RE = re.compile(r"^([XYZ])(\d+)$")
_PAULI_CODE = {"X": 1, "Y": 2, "Z": 3}


@dataclass
class Op:
    """A single compiled circuit operation.

    Probability parameters: single-parameter channels carry ``arg``;
    multi-parameter channels (``PAULI_CHANNEL_1/2``) carry ``args`` (a
    float32 vector) and leave ``arg`` None.
    """

    name: str
    arg: Optional[float]
    targets: np.ndarray  # int32; for 2-qubit ops, interleaved pairs (a0 b0 a1 b1 ...)
    meas_offset: int = -1  # index of first measurement this op records (within its block)
    args: Optional[np.ndarray] = None  # multi-parameter channel probabilities
    # correlated channels only: per-target Pauli codes (1=X, 2=Y, 3=Z),
    # aligned with ``targets``
    paulis: Optional[np.ndarray] = None

    @property
    def num_measurements(self) -> int:
        if self.name in GATES_1Q_MEAS or self.name in GATES_1Q_MEAS_RESET:
            return len(self.targets)
        return 0

    @property
    def num_noise_args(self) -> int:
        """Slots this op consumes in the runtime noise-probability vector."""
        if self.args is not None:
            return len(self.args)
        return 0 if self.arg is None else 1


@dataclass
class ParsedCircuit:
    """Structured circuit: prologue, one optional repeated block, epilogue."""

    num_qubits: int
    prologue: List[Op]
    repeat_count: int
    body: List[Op]
    epilogue: List[Op]
    prologue_measurements: int
    body_measurements: int
    epilogue_measurements: int
    detectors: List[List[int]] = field(default_factory=list)  # absolute measurement idx
    observables: List[List[int]] = field(default_factory=list)

    @property
    def num_measurements(self) -> int:
        return (
            self.prologue_measurements
            + self.repeat_count * self.body_measurements
            + self.epilogue_measurements
        )

    @property
    def num_detectors(self) -> int:
        return len(self.detectors)

    @property
    def num_observables(self) -> int:
        return len(self.observables)

    def flat_ops(self) -> List[Op]:
        """The fully unrolled op stream (body repeated `repeat_count` times)."""
        return list(self.prologue) + self.repeat_count * list(self.body) + list(self.epilogue)

    def structure_signature(self) -> tuple:
        """Hashable signature of everything EXCEPT noise-probability values.

        Two circuits with equal signatures (e.g. the same storage experiment
        at different physical error rates) can share one compiled device
        sampler, re-bound to a new :meth:`noise_args` vector at runtime."""
        def block_sig(ops):
            return tuple(
                (op.name, op.num_noise_args, op.targets.tobytes(), op.meas_offset,
                 None if op.paulis is None else op.paulis.tobytes())
                for op in ops
            )
        return (
            self.num_qubits, self.repeat_count,
            block_sig(self.prologue), block_sig(self.body),
            block_sig(self.epilogue),
            tuple(map(tuple, self.detectors)), tuple(map(tuple, self.observables)),
        )

    def noise_args(self) -> np.ndarray:
        """The probability arguments of all arg-carrying ops, in block order
        (prologue, body, epilogue) — the runtime-rebindable part of the
        circuit.  Index order matches the parametric device sampler; a
        multi-parameter channel contributes its parameters consecutively."""
        vals: List[float] = []
        for ops in (self.prologue, self.body, self.epilogue):
            for op in ops:
                if op.args is not None:
                    vals.extend(float(v) for v in op.args)
                elif op.arg is not None:
                    vals.append(op.arg)
        return np.asarray(vals, dtype=np.float32)

    def detector_matrix(self) -> sparse.csr_matrix:
        """(num_detectors, num_measurements) 0/1 matrix; detector bits are
        ``record @ D.T mod 2``."""
        rows, cols = [], []
        for i, recs in enumerate(self.detectors):
            rows.extend([i] * len(recs))
            cols.extend(recs)
        return sparse.csr_matrix(
            (np.ones(len(rows), dtype=np.uint8), (rows, cols)),
            shape=(len(self.detectors), self.num_measurements),
        )

    def observable_matrix(self) -> sparse.csr_matrix:
        rows, cols = [], []
        for i, recs in enumerate(self.observables):
            rows.extend([i] * len(recs))
            cols.extend(recs)
        return sparse.csr_matrix(
            (np.ones(len(rows), dtype=np.uint8), (rows, cols)),
            shape=(len(self.observables), self.num_measurements),
        )


def _parse_rec_targets(rest: str, meas_count: int) -> List[int]:
    out = []
    for m in _REC_RE.finditer(rest):
        k = int(m.group(1))
        idx = meas_count + k
        if idx < 0:
            raise ValueError(f"rec[{k}] refers before the start of the record")
        out.append(idx)
    return out


def _fuse(ops: List[Op]) -> List[Op]:
    """Merge adjacent same-kind/same-arg fusable ops into index-array ops.

    BARRIER (TICK) ops fence the fusion — within one timestep the
    unique-target invariant (``storage_sim.py:89-108``) guarantees fused
    index arrays are duplicate-free, across timesteps it does not — and are
    dropped from the compiled stream afterwards.
    """
    fused: List[Op] = []
    for op in ops:
        if op.name == "BARRIER":
            fused.append(op)
            continue
        if (
            fused
            and op.name in FUSABLE
            and fused[-1].name == op.name
            and fused[-1].arg == op.arg
            and (
                (fused[-1].args is None and op.args is None)
                or (
                    fused[-1].args is not None
                    and op.args is not None
                    and np.array_equal(fused[-1].args, op.args)
                )
            )
        ):
            fused[-1] = Op(
                op.name,
                op.arg,
                np.concatenate([fused[-1].targets, op.targets]),
                fused[-1].meas_offset,
                args=fused[-1].args,
            )
        else:
            fused.append(op)
    return [op for op in fused if op.name != "BARRIER"]


def parse_circuit(circuit) -> ParsedCircuit:
    """Parse Stim-format text (string or iterable of lines) into a ParsedCircuit.

    Supports the vocabulary emitted by the circuit generator and noise models
    (``storage_sim.py:77-87`` plus R/M/MR/CX/CZ/TICK/REPEAT/DETECTOR/
    OBSERVABLE_INCLUDE/SHIFT_COORDS/QUBIT_COORDS).  At most one top-level
    REPEAT block is represented structurally; additional blocks are unrolled.
    """
    if isinstance(circuit, str):
        lines = circuit.split("\n")
    else:
        lines = list(circuit)

    prologue: List[Op] = []
    body: List[Op] = []
    epilogue: List[Op] = []
    repeat_count = 0
    detectors: List[List[int]] = []
    observables: Dict[int, List[int]] = {}
    max_qubit = -1
    meas_count = 0

    # which list new ops append to; structural phases: 0 = prologue, 1 = in-repeat,
    # 2 = epilogue (after the structural repeat closes)
    phase = 0

    block_meas = [0, 0, 0]

    def current_list() -> List[Op]:
        return (prologue, body, epilogue)[phase]

    def emit(name: str, arg, targets: List[int], args=None, paulis=None):
        nonlocal max_qubit, meas_count
        arr = np.asarray(targets, dtype=np.int32)
        if arr.size:
            max_qubit = max(max_qubit, int(arr.max()))
        op = Op(name, arg, arr, meas_offset=block_meas[phase], args=args,
                paulis=paulis)
        nmeas = op.num_measurements
        block_meas[phase] += nmeas
        meas_count += nmeas
        current_list().append(op)

    def handle_line(line: str):
        nonlocal phase, repeat_count, meas_count
        m = _LINE_RE.match(line)
        if m is None or not m.group(1):
            return
        name = m.group(1).upper()
        name = _ALIASES.get(name, name)
        argstr, rest = m.group(2), m.group(3)
        arg = float(argstr.split(",")[0]) if argstr not in (None, "") else None

        if name == "TICK":
            # barrier marker: prevents fusing gate layers across timesteps,
            # which would put duplicate indices into one scatter op
            current_list().append(Op("BARRIER", None, np.empty(0, dtype=np.int32)))
            return
        if name in ("SHIFT_COORDS", "QUBIT_COORDS"):
            return
        if name == "DETECTOR":
            detectors.append(_parse_rec_targets(rest, meas_count))
            return
        if name == "OBSERVABLE_INCLUDE":
            idx = int(float(argstr)) if argstr else 0
            observables.setdefault(idx, []).extend(_parse_rec_targets(rest, meas_count))
            return
        if name in NOISE_CORRELATED:
            if arg is None:
                raise ValueError(f"{name} requires a probability: {line!r}")
            qubits: List[int] = []
            codes: List[int] = []
            for tok in rest.split():
                pm = _PAULI_TARGET_RE.match(tok.upper())
                if pm is None:
                    raise ValueError(
                        f"{name} takes Pauli targets like X1 Y2 Z3, "
                        f"got {tok!r}: {line!r}")
                codes.append(_PAULI_CODE[pm.group(1)])
                qubits.append(int(pm.group(2)))
            if len(set(qubits)) != len(qubits):
                raise ValueError(f"duplicate qubit in Pauli product: {line!r}")
            if name == "ELSE_CORRELATED_ERROR":
                prev = current_list()[-1].name if current_list() else None
                if prev not in NOISE_CORRELATED:
                    raise ValueError(
                        "ELSE_CORRELATED_ERROR must immediately follow a "
                        "CORRELATED_ERROR / ELSE_CORRELATED_ERROR in the "
                        f"same block: {line!r}")
            emit(name, arg, qubits,
                 paulis=np.asarray(codes, dtype=np.uint8))
            return
        if name in NOISE_MULTI_ARG:
            want = NOISE_MULTI_ARG[name]
            vals = [float(v) for v in argstr.split(",")] if argstr else []
            if len(vals) != want:
                raise ValueError(
                    f"{name} takes exactly {want} probabilities, "
                    f"got {len(vals)}: {line!r}"
                )
            targets = [int(t) for t in rest.split()] if rest else []
            if name == "PAULI_CHANNEL_2" and len(targets) % 2:
                raise ValueError(f"odd number of targets for 2-qubit op: {line}")
            emit(name, None, targets, args=np.asarray(vals, dtype=np.float32))
            return
        targets = [int(t) for t in rest.split()] if rest else []
        if name in GATES_1Q_RESET | GATES_1Q_MEAS | GATES_1Q_MEAS_RESET | GATES_2Q | NOISE_1Q | NOISE_2Q:
            if name in GATES_2Q | NOISE_2Q:
                if len(targets) % 2:
                    raise ValueError(f"odd number of targets for 2-qubit op: {line}")
            emit(name, arg, targets)
            return
        raise ValueError(f"unsupported circuit instruction: {line!r}")

    i = 0
    while i < len(lines):
        raw = lines[i]
        stripped = raw.split("#")[0].strip()
        i += 1
        if not stripped:
            continue
        first = stripped.split()[0].upper()
        if first == "REPEAT":
            count = int(stripped.split()[1])
            # collect the block
            block_lines: List[str] = []
            depth = 1
            while i < len(lines) and depth > 0:
                inner = lines[i].split("#")[0].strip()
                i += 1
                if inner.split()[:1] and inner.split()[0].upper() == "REPEAT":
                    depth += 1
                elif inner == "}":
                    depth -= 1
                    if depth == 0:
                        break
                block_lines.append(lines[i - 1])
            if phase == 0:
                # structural repeat: parse body once; replicate its detectors and
                # measurement count for the remaining iterations
                phase = 1
                repeat_count = count
                n_det_before_body = len(detectors)
                for bl in block_lines:
                    handle_line(bl)
                body_detectors = detectors[n_det_before_body:]
                for it in range(1, count):
                    shift = it * block_meas[1]
                    detectors.extend([x + shift for x in d] for d in body_detectors)
                meas_count += (count - 1) * block_meas[1]
                phase = 2
            else:
                # non-structural repeat: unroll inline
                for _ in range(count):
                    for bl in block_lines:
                        handle_line(bl)
            continue
        if stripped == "}":
            raise ValueError("unmatched '}' in circuit")
        handle_line(stripped)

    obs_list = [observables[k] for k in sorted(observables)] if observables else []
    if observables:
        assert sorted(observables) == list(range(len(observables))), "observable ids must be dense"

    return ParsedCircuit(
        num_qubits=max_qubit + 1,
        prologue=_fuse(prologue),
        repeat_count=repeat_count if repeat_count else 0,
        body=_fuse(body),
        epilogue=_fuse(epilogue),
        prologue_measurements=block_meas[0],
        body_measurements=block_meas[1],
        epilogue_measurements=block_meas[2],
        detectors=detectors,
        observables=obs_list,
    )
