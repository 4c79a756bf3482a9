"""Syndrome-extraction and storage-experiment circuit generation.

Behavioral parity with ``reference/python/qldpc/storage_sim.py``:
depth-optimal CX/CZ scheduling via bipartite edge coloring, Stim-text
emission with DETECTOR/OBSERVABLE_INCLUDE annotations, REPEAT-block
steady-state rounds, and measurement-record view closures.

Measurement-record contract (identical to the reference,
``storage_sim.py:187-196``): for each round a block of
``[x_checks..., z_checks...]`` outcomes in check-index order, followed by
``num_data`` transversal readout bits.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
from scipy import sparse

from ..core import CircuitTargets, NoiseRewriter, QuantumCode, StorageSim, num_rows
from .graph_coloring import color_csr_checks

__all__ = [
    "order_measurements",
    "build_perfect_circuit",
    "build_storage_simulation",
    "noise_channels",
]

noise_channels = (
    "CORRELATED_ERROR",
    "DEPOLARIZE1",
    "DEPOLARIZE2",
    "ELSE_CORRELATED_ERROR",
    "PAULI_CHANNEL_1",
    "PAULI_CHANNEL_2",
    "X_ERROR",
    "Y_ERROR",
    "Z_ERROR",
)

MeasurementOrder = Tuple[int, List[Dict[int, int]]]


def order_measurements(code: QuantumCode) -> Tuple[int, MeasurementOrder, MeasurementOrder]:
    """Edge-color each basis' Tanner graph into per-timestep {check: data} maps
    (``storage_sim.py:12-36``); X and Z checks are scheduled separately."""

    def build_order(checks: sparse.csr_matrix):
        schedule = color_csr_checks(checks)
        return (checks.shape[1], checks.shape[0], schedule)

    x_data, x_checks, xorder = build_order(code.checks.x)
    z_data, z_checks, zorder = build_order(code.checks.z)
    assert x_data == z_data
    return (x_data, (x_checks, xorder), (z_checks, zorder))


def build_perfect_circuit(code: QuantumCode) -> Tuple[CircuitTargets, List[str]]:
    """One noiseless round: RX x-ancillas, colored CX layers, MRX; then the
    same for Z checks with CZ (``storage_sim.py:38-75``).  TICK-separated;
    the trailing TICK is left off so rounds can be interleaved."""
    num_data, (x_count, x_schedule), (z_count, z_schedule) = order_measurements(code)

    x_ancillas = list(range(num_data, num_data + x_count))
    z_ancillas = list(range(num_data + x_count, num_data + x_count + z_count))
    x_anc_str = " ".join(str(v) for v in x_ancillas)
    z_anc_str = " ".join(str(v) for v in z_ancillas)

    circuit: List[str] = []
    circuit.append(f"RX {x_anc_str}")
    circuit.append("TICK")

    if x_count > 0:
        for layer in x_schedule:
            circuit.extend(
                f"CX {x_ancillas[check]} {target}" for check, target in layer.items()
            )
            circuit.append("TICK")
        circuit.append(f"MRX {x_anc_str}")

    circuit.append(f"RX {z_anc_str}")
    circuit.append("TICK")

    if z_count > 0:
        for layer in z_schedule:
            circuit.extend(
                f"CZ {z_ancillas[check]} {target}" for check, target in layer.items()
            )
            circuit.append("TICK")
        circuit.append(f"MRX {z_anc_str}")

    targets = CircuitTargets(list(range(num_data)), x_ancillas, z_ancillas)
    return targets, circuit


def _check_unique_targets(circuit: str) -> None:
    """Physical race detector: no qubit may be touched twice in a timestep
    (``storage_sim.py:89-108``).

    Unlike the reference's verifier, control-flow lines are skipped
    explicitly: the reference parses ``REPEAT n {`` as a gate line and
    collects ``n`` as a qubit target (``storage_sim.py:100-107``), which
    false-asserts whenever the round count collides with an ancilla index
    already used in the same timestep.
    """
    _CONTROL_FLOW = ("REPEAT", "}", "SHIFT_COORDS", "TICK", "QUBIT_COORDS")

    def gate_lines_only(chunk: str):
        for line in chunk.split("\n"):
            stripped = line.strip()
            if stripped.startswith(noise_channels) or stripped.startswith(
                ("DETECTOR", "OBSERVABLE")
            ):
                continue
            if stripped.startswith(_CONTROL_FLOW):
                continue
            yield stripped

    for chunk in circuit.split("TICK"):
        targets = []
        for line in gate_lines_only(chunk):
            for tok in line.split():
                try:
                    targets.append(int(tok))
                except ValueError:
                    pass
        assert len(targets) == len(frozenset(targets)), "qubit touched twice in one timestep"


def build_storage_simulation(
    rounds: int, noise_model: NoiseRewriter, code: QuantumCode, use_x_logicals=None
) -> StorageSim:
    """Prepare a logical |0> (or |+>), run `rounds` QEC cycles, read out
    transversally; emit the annotated Stim-text circuit plus record views
    (``storage_sim.py:110-199``)."""
    if use_x_logicals is None:
        use_x_logicals = False

    checks = code.checks
    basis = "X" if use_x_logicals else "Z"

    targets, extraction_circuit = build_perfect_circuit(code)
    x_count = len(targets.x_checks)
    z_count = len(targets.z_checks)
    mpr = x_count + z_count  # measurements per round
    num_data = len(targets.data)

    circuit: List[str] = []
    # ===== initialize data =====
    circuit.append(f'R{basis} {" ".join(str(i) for i in targets.data)}')
    circuit.append("TICK")

    # ===== repeated syndrome-extraction rounds =====
    if rounds > 0:
        circuit.extend(extraction_circuit)
        # product-state start: only one basis is deterministic in round 1
        deterministic = range(0, x_count) if use_x_logicals else range(x_count, mpr)
        circuit.extend(f"DETECTOR(0, {i}) rec[{i - mpr}]" for i in deterministic)

        if rounds > 1:
            circuit.append("TICK")
            circuit.append(f"REPEAT {rounds - 1} {{")
            circuit.extend(extraction_circuit)
            circuit.append("SHIFT_COORDS(1, 0)")
            circuit.extend(
                f"DETECTOR(0, {i}) rec[{i - mpr}] rec[{i - 2 * mpr}]" for i in range(mpr)
            )
            circuit.append("TICK")
            circuit.append("}")

    # ===== transversal readout + final detectors =====
    circuit.append(f'M{basis} {" ".join(str(i) for i in targets.data)}')

    records = lambda support: " ".join(f"rec[{v - num_data}]" for v in support)
    final_checks = checks.x if use_x_logicals else checks.z
    final_logicals = code.logicals.x if use_x_logicals else code.logicals.z
    # offset of check i's previous-round measurement relative to the end of the record
    prev_round_offset = lambda i: (
        i - num_data - mpr if use_x_logicals else i - num_data - mpr + x_count
    )
    circuit.extend(
        f"DETECTOR(1, {i}) "
        + (f"rec[{prev_round_offset(i)}] " if rounds > 0 else "")
        + records(final_checks[[i], :].nonzero()[1])
        for i in range(final_checks.shape[0])
    )
    circuit.extend(
        f"OBSERVABLE_INCLUDE({i}) " + records(np.nonzero(final_logicals[[i], :])[1])
        for i in range(final_logicals.shape[0])
    )

    # ===== noise rewriting + race check =====
    circuit = list(noise_model.rewrite(targets, circuit))
    _check_unique_targets("\n".join(circuit))

    def meas_result(round_index, get_x_checks, measurement_vector, *_):
        offset = mpr * round_index + (0 if get_x_checks else x_count)
        count = x_count if get_x_checks else z_count
        return measurement_vector[offset : offset + count]

    def data_result(measurement_vector, *_):
        offset = mpr * rounds
        return measurement_vector[offset : offset + num_data]

    return StorageSim(circuit, meas_result, data_result)
