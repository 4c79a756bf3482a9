"""Noise models as table-driven channel-insertion passes over Stim text.

Behavioral parity (line-by-line, golden-tested) with
``reference/python/qldpc/noise_model.py``: the OUTPUT text — channel
names, probability formatting, target ordering, placement relative to TICK
boundaries — is the interchange contract with the reference ecosystem and
is pinned byte-for-byte by ``tests/test_storage_sim.py``.  The internal
architecture is different by design: where the reference implements each
noise model as its own imperative rewrite closure over re-parsed timesteps
(``noise_model.py:117-151``), here ONE streaming scanner
(:func:`_scan_timesteps`) classifies the circuit into timestep records
(lines, two-qubit pairs, measurement flag) in a single pass, and ONE
generic engine (:func:`_apply_channel_table`) inserts channels according to
a declarative :class:`_ChannelTable`; the public noise models are
three-line table constructors.

The text representation is kept deliberately; the TPU sampler consumes the
rewritten text via its own structured parser
(:mod:`exp_ldpc_tpu.circuits.ir`).
"""
from __future__ import annotations

import re
import warnings
from dataclasses import dataclass
from typing import Callable, Iterable, Iterator, List, Optional, Tuple

from ..core import CircuitTargets, NoiseRewriter

__all__ = [
    "trivial_noise",
    "depolarizing_noise",
    "circuit_noise",
    "apply_noise_pred",
    "circuit_ticks",
    "tokenize_line",
    "get_two_qubit_targets",
]

_MEASUREMENT_GATES = ["M", "MZ", "MX", "MY", "MPP", "MR", "MRZ", "MRX", "MRY"]
# the rewrite must preserve the original target spacing byte-for-byte
# (pinned interop format), so measurement lines are matched/split with a
# regex rather than re-serialized from tokens
_MEASUREMENT_LINE = re.compile(
    f'^(?:\\s*)({"|".join(_MEASUREMENT_GATES)})((?:\\s*\\d+\\s*)+)$'
)

_TWO_QUBIT_GATES = frozenset(
    [
        "CNOT", "CX", "CY", "CZ",
        "ISWAP", "ISWAP_DAG",
        "SQRT_XX", "SQRT_XX_DAG", "SQRT_YY", "SQRT_YY_DAG", "SQRT_ZZ", "SQRT_ZZ_DAG",
        "SWAP",
        "XCX", "XCY", "XCZ", "YCX", "YCY", "YCZ", "ZCX", "ZCY", "ZCZ",
    ]
)


def tokenize_line(line: str) -> List[str]:
    """Split a Stim line into upper-cased tokens, dropping comments
    (reference surface: ``noise_model.py:99-101``)."""
    return [s.upper() for s in line.split("#")[0].split() if s != ""]


def get_two_qubit_targets(line: str) -> List[Tuple[int, int]]:
    """Target pairs of any two-qubit gate on the line (reference surface:
    ``noise_model.py:103-112``)."""
    tokens = tokenize_line(line)
    if len(tokens) > 1 and tokens[0] in _TWO_QUBIT_GATES:
        targets = [int(t) for t in tokens[1:]]
        if len(targets) % 2 == 1:
            raise ValueError(
                f"two-qubit gate line has an odd target count: {line!r}"
            )
        return list(zip(targets[::2], targets[1::2]))
    return []


@dataclass(frozen=True)
class _Timestep:
    """One classified timestep: the single-pass scan product every noise
    pass consumes (no per-model re-parsing)."""

    lines: Tuple[str, ...]
    leading_tick: bool            # first line is the TICK separator
    pairs: Tuple[Tuple[int, int], ...]  # two-qubit gate targets, in order
    measured: bool                # contains at least one measurement line


def _scan_timesteps(circuit: Iterable[str]) -> Iterator[_Timestep]:
    """Stream a circuit into :class:`_Timestep` records in ONE pass,
    classifying each line exactly once.

    Emits the malformed-control-flow warning the reference intended (its
    version had a dead flag, SURVEY.md §2.5.3): a ``REPEAT``/``}`` line not
    at the start of a timestep means tick detection may be wrong.
    """
    lines: List[str] = []
    pairs: List[Tuple[int, int]] = []
    measured = False
    leading_tick = False
    at_tick_boundary = True

    def flush() -> _Timestep:
        return _Timestep(tuple(lines), leading_tick, tuple(pairs), measured)

    for line in circuit:
        tokens = tokenize_line(line)
        if tokens:
            if tokens[0] in ("REPEAT", "}") and not at_tick_boundary:
                warnings.warn(
                    "This circuit has control flow not aligned to TICK boundaries; "
                    "timestep detection may be incorrect. Put REPEAT blocks in the form "
                    "TICK / REPEAT n { ... TICK / } or flatten the circuit first."
                )
            if tokens[0] == "TICK":
                yield flush()
                lines, pairs, measured = [line], [], False
                leading_tick = True
                at_tick_boundary = True
                continue
            at_tick_boundary = False
            if tokens[0] in _TWO_QUBIT_GATES:
                pairs.extend(get_two_qubit_targets(line))
            elif _MEASUREMENT_LINE.search(line) is not None:
                measured = True
        lines.append(line)
    yield flush()


def circuit_ticks(circuit: Iterable[str]) -> List[List[str]]:
    """Group lines into timesteps; each TICK starts a new group with the
    TICK line first (reference surface: ``noise_model.py:30-67``)."""
    return [list(step.lines) for step in _scan_timesteps(circuit)]


def _flip_measurements(line: str, p: float) -> str:
    """M/MX/MRX... -> M(p)/MX(p)/MRX(p)..., preserving the original target
    spacing (pinned output format, reference ``noise_model.py:154-161``)."""
    m = _MEASUREMENT_LINE.search(line)
    if m is None:
        return line
    return f"{m.group(1)}({p}){m.group(2)}"


def _channel_line(channel: str, p: float, qubits: Iterable[int]) -> str:
    """One noise-channel line in the pinned output format."""
    return f"{channel}({p}) " + " ".join(str(q) for q in qubits)


@dataclass(frozen=True)
class _ChannelTable:
    """Declarative description of a noise model: which channels to insert
    where.  ``None`` disables a channel; the generic engine below is the
    only code that interprets the fields."""

    measured_steps_only: bool = False   # touch only measurement timesteps
    flip_p: Optional[float] = None      # measurement-flip probability
    data_before_p: Optional[float] = None   # DEPOLARIZE1 on data, pre-step
    pair_after_p: Optional[float] = None    # DEPOLARIZE2 after 2q gates
    idle_after_p: Optional[float] = None    # DEPOLARIZE1 on untouched qubits


def _apply_channel_table(table: _ChannelTable, targets: CircuitTargets,
                         circuit: Iterable[str]) -> List[str]:
    """The single channel-insertion engine all shipped noise models share."""
    out: List[str] = []
    support = frozenset(targets.data) | frozenset(targets.ancillas)
    for step in _scan_timesteps(circuit):
        if table.measured_steps_only and not (step.lines and step.measured):
            out.extend(step.lines)
            continue
        body = list(step.lines)
        if table.data_before_p is not None:
            # pre-step channels go after the TICK separator, before gates
            if step.leading_tick:
                out.append(body.pop(0))
            out.append(_channel_line("DEPOLARIZE1", table.data_before_p,
                                     targets.data))
        if table.flip_p is not None:
            body = [_flip_measurements(line, table.flip_p) for line in body]
        out.extend(body)
        if table.pair_after_p is not None and step.pairs:
            out.append(_channel_line(
                "DEPOLARIZE2", table.pair_after_p,
                (q for pair in step.pairs for q in pair)))
        if table.idle_after_p is not None:
            busy = frozenset(q for pair in step.pairs for q in pair)
            out.append(_channel_line("DEPOLARIZE1", table.idle_after_p,
                                     sorted(support - busy)))
    return out


def _table_rewriter(table: _ChannelTable) -> NoiseRewriter:
    return NoiseRewriter(
        lambda targets, circuit: _apply_channel_table(table, targets, circuit))


def trivial_noise() -> NoiseRewriter:
    """No-op noise model (reference surface: ``noise_model.py:11-13``)."""
    return _table_rewriter(_ChannelTable(measured_steps_only=True, flip_p=None))


def depolarizing_noise(p: float, pm: float) -> NoiseRewriter:
    """Phenomenological noise: DEPOLARIZE1(p) on data before any timestep
    containing measurements, plus measurement flips with probability pm
    (behavioral parity: ``noise_model.py:117-123``)."""
    return _table_rewriter(_ChannelTable(
        measured_steps_only=True, flip_p=pm, data_before_p=p))


def circuit_noise(p: float, pm: float = None) -> NoiseRewriter:
    """Circuit-level noise: DEPOLARIZE2 after two-qubit gates, DEPOLARIZE1
    on every other circuit qubit each timestep, measurement flips pm
    (default p) (behavioral parity: ``noise_model.py:125-151``)."""
    return _table_rewriter(_ChannelTable(
        flip_p=p if pm is None else pm, pair_after_p=p, idle_after_p=p))


def apply_noise_pred(
    predicate: Callable[[CircuitTargets, Iterable[str]], bool],
    noise_before: Callable[[CircuitTargets], List[str]] = None,
    noise_after: Callable[[CircuitTargets], List[str]] = None,
    line_rewriter: Callable[[CircuitTargets, str], str] = None,
) -> NoiseRewriter:
    """Per-timestep predicate-driven rewriter combinator — the extension
    point for USER noise models beyond the shipped tables (reference
    surface: ``noise_model.py:15-28``)."""

    def _impl(targets: CircuitTargets, circuit: Iterable[str]) -> List[str]:
        nb = noise_before or (lambda *_: [])
        na = noise_after or (lambda *_: [])
        lr = line_rewriter or (lambda _, x: x)

        out: List[str] = []
        for step in _scan_timesteps(circuit):
            body = list(step.lines)
            if not (body and predicate(targets, body)):
                out.extend(body)
                continue
            if step.leading_tick:
                out.append(body.pop(0))
            out.extend(nb(targets))
            out.extend(lr(targets, line) for line in body)
            out.extend(na(targets))
        return out

    return NoiseRewriter(_impl)
