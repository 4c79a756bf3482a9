"""Detector error model built by exhaustive single-fault propagation.

Replaces ``stim.Circuit.detector_error_model()`` (used by the reference at
``misc/_experiment.py:174`` and ``spacetime_code.py:130``).  Every noise-op
component in the circuit becomes one candidate fault:

  * DEPOLARIZE1(p) on q   -> X, Y, Z on q, each p/3
  * DEPOLARIZE2(p) on a,b -> the 15 non-identity two-qubit Paulis, each p/15
  * X/Y/Z_ERROR(p) on q   -> that Pauli, p
  * PAULI_CHANNEL_1(px,py,pz) on q -> X/Y/Z on q with their own priors
  * PAULI_CHANNEL_2(p1..p15) on a,b -> each two-qubit Pauli with its prior
  * CORRELATED_ERROR / ELSE_CORRELATED_ERROR chain -> one fault per member
    (the whole Pauli product), prior converted to the unconditional
    p * prod_earlier(1 - p_j)
  * M*(p) measurement     -> flip of that record bit, p

(the same independent-decomposition approximation stim's DEM uses for
correlated channels).  All faults propagate in ONE batched deterministic
Pauli-frame pass — the fault axis is the batch axis, so building the DEM is
the same vectorized computation as sampling — then faults with identical
(detector set, observable set) signatures merge with
p = p1(1-p2) + p2(1-p1), and zero-signature faults are dropped.

Unlike the reference's ``DetectorSpacetimeCode`` ingestion (confirmed bug,
SURVEY.md §2.5.1), fault columns here connect to the true detector ids.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
from scipy import sparse

from ..circuits.ir import ParsedCircuit, parse_circuit

__all__ = ["DetectorErrorModel", "detector_error_model"]


@dataclass(frozen=True, eq=False)
class DetectorErrorModel:
    fault_detectors: sparse.csr_matrix  # (num_detectors, num_faults)
    fault_observables: sparse.csr_matrix  # (num_observables, num_faults)
    priors: np.ndarray  # (num_faults,)

    @property
    def num_faults(self) -> int:
        return self.priors.shape[0]


_PAULI2 = [(k & 1, (k >> 1) & 1, (k >> 2) & 1, (k >> 3) & 1) for k in range(1, 16)]


def detector_error_model(circuit) -> DetectorErrorModel:
    if not isinstance(circuit, ParsedCircuit):
        circuit = parse_circuit(circuit)
    ops = circuit.flat_ops()
    Q = circuit.num_qubits
    M = circuit.num_measurements

    # ---- enumerate faults ----
    # each fault: (op_index, kind) where kind describes the injection
    fault_x: List[List[int]] = []  # qubits getting an X component
    fault_z: List[List[int]] = []
    fault_meas: List[int] = []  # record index flipped (-1 = none)
    fault_op: List[int] = []
    priors: List[float] = []

    meas_base = 0
    # running P(no earlier member of the current CORRELATED_ERROR chain
    # fired): converts chain-conditional probabilities to unconditional
    # fault priors (an ELSE with prob p fires unconditionally with
    # p * prod_earlier(1 - p_j))
    chain_comp = 1.0
    for k, op in enumerate(ops):
        t = op.targets
        if op.name in ("CORRELATED_ERROR", "ELSE_CORRELATED_ERROR"):
            p = float(op.arg or 0.0)
            if op.name == "CORRELATED_ERROR":
                chain_comp = 1.0
            prior = p * chain_comp
            chain_comp *= 1.0 - p
            if prior:
                paulis = np.asarray(op.paulis)
                fault_x.append(t[(paulis == 1) | (paulis == 2)].tolist())
                fault_z.append(t[(paulis == 2) | (paulis == 3)].tolist())
                fault_meas.append(-1)
                fault_op.append(k)
                priors.append(prior)
            continue
        if op.name in ("MZ", "MRZ", "MX", "MRX"):
            if op.arg:
                for j in range(t.size):
                    fault_x.append([])
                    fault_z.append([])
                    fault_meas.append(meas_base + j)
                    fault_op.append(k)
                    priors.append(float(op.arg))
            meas_base += t.size
        elif op.name == "DEPOLARIZE1" and op.arg:
            for q in t.tolist():
                for (ex, ez) in ((1, 0), (1, 1), (0, 1)):
                    fault_x.append([q] if ex else [])
                    fault_z.append([q] if ez else [])
                    fault_meas.append(-1)
                    fault_op.append(k)
                    priors.append(float(op.arg) / 3.0)
        elif op.name == "DEPOLARIZE2" and op.arg:
            for a, b in zip(t.tolist()[0::2], t.tolist()[1::2]):
                for (xa, za, xb, zb) in _PAULI2:
                    fault_x.append(([a] if xa else []) + ([b] if xb else []))
                    fault_z.append(([a] if za else []) + ([b] if zb else []))
                    fault_meas.append(-1)
                    fault_op.append(k)
                    priors.append(float(op.arg) / 15.0)
        elif op.name in ("X_ERROR", "Y_ERROR", "Z_ERROR") and op.arg:
            for q in t.tolist():
                fault_x.append([q] if op.name in ("X_ERROR", "Y_ERROR") else [])
                fault_z.append([q] if op.name in ("Z_ERROR", "Y_ERROR") else [])
                fault_meas.append(-1)
                fault_op.append(k)
                priors.append(float(op.arg))
        elif op.name == "PAULI_CHANNEL_1" and op.args is not None:
            # disjoint (px, py, pz): three faults with their own priors
            for q in t.tolist():
                for (ex, ez), p in zip(((1, 0), (1, 1), (0, 1)), op.args):
                    if not p:
                        continue
                    fault_x.append([q] if ex else [])
                    fault_z.append([q] if ez else [])
                    fault_meas.append(-1)
                    fault_op.append(k)
                    priors.append(float(p))
        elif op.name == "PAULI_CHANNEL_2" and op.args is not None:
            # parameter k (1-based, Stim order IX..ZZ) is the pair with
            # code 4*A + B = k; per-Pauli priors, not the uniform p/15
            for a, b in zip(t.tolist()[0::2], t.tolist()[1::2]):
                for code, p in enumerate(op.args, start=1):
                    if not p:
                        continue
                    pa, pb = code // 4, code % 4
                    fault_x.append(
                        ([a] if pa in (1, 2) else []) + ([b] if pb in (1, 2) else []))
                    fault_z.append(
                        ([a] if pa in (2, 3) else []) + ([b] if pb in (2, 3) else []))
                    fault_meas.append(-1)
                    fault_op.append(k)
                    priors.append(float(p))

    F = len(priors)
    if F == 0:
        return DetectorErrorModel(
            sparse.csr_matrix((circuit.num_detectors, 0), dtype=np.uint8),
            sparse.csr_matrix((circuit.num_observables, 0), dtype=np.uint8),
            np.zeros(0),
        )

    # group fault injections by op index
    by_op: Dict[int, List[int]] = {}
    for f, k in enumerate(fault_op):
        by_op.setdefault(k, []).append(f)

    # ---- one deterministic batched frame pass, faults on the batch axis ----
    fx = np.zeros((F, Q), dtype=np.uint8)
    fz = np.zeros((F, Q), dtype=np.uint8)
    record = np.zeros((F, M), dtype=np.uint8)
    meas_base = 0
    for k, op in enumerate(ops):
        # inject this op's faults (noise acts at its position in the stream)
        for f in by_op.get(k, ()):
            if fault_meas[f] < 0:
                if fault_x[f]:
                    fx[f, fault_x[f]] ^= 1
                if fault_z[f]:
                    fz[f, fault_z[f]] ^= 1
        t = op.targets
        name = op.name
        if name == "RZ":
            fx[:, t] = 0
            fz[:, t] = 0
        elif name == "RX":
            fx[:, t] = 0
            fz[:, t] = 0
        elif name in ("MZ", "MRZ"):
            record[:, meas_base : meas_base + t.size] = fx[:, t]
            meas_base += t.size
            if name == "MRZ":
                fx[:, t] = 0
                fz[:, t] = 0
        elif name in ("MX", "MRX"):
            record[:, meas_base : meas_base + t.size] = fz[:, t]
            meas_base += t.size
            if name == "MRX":
                fx[:, t] = 0
                fz[:, t] = 0
        elif name == "CX":
            c, g = t[0::2], t[1::2]
            fx[:, g] ^= fx[:, c]
            fz[:, c] ^= fz[:, g]
        elif name == "CZ":
            a, b = t[0::2], t[1::2]
            za = fz[:, a] ^ fx[:, b]
            zb = fz[:, b] ^ fx[:, a]
            fz[:, a] = za
            fz[:, b] = zb
        # noise ops themselves: no deterministic action beyond the injections

    # measurement-flip faults
    for f, mi in enumerate(fault_meas):
        if mi >= 0:
            record[f, mi] ^= 1

    det = (record @ circuit.detector_matrix().T.toarray()) % 2  # (F, D)
    obs = (record @ circuit.observable_matrix().T.toarray()) % 2  # (F, L)

    # ---- merge identical signatures ----
    merged: Dict[bytes, int] = {}
    sig_det: List[np.ndarray] = []
    sig_obs: List[np.ndarray] = []
    merged_p: List[float] = []
    for f in range(F):
        d = det[f]
        o = obs[f]
        if not d.any() and not o.any():
            continue
        key = d.tobytes() + b"|" + o.tobytes()
        if key in merged:
            i = merged[key]
            p1, p2 = merged_p[i], priors[f]
            merged_p[i] = p1 * (1 - p2) + p2 * (1 - p1)
        else:
            merged[key] = len(merged_p)
            sig_det.append(d)
            sig_obs.append(o)
            merged_p.append(priors[f])

    Fm = len(merged_p)
    D = circuit.num_detectors
    L = circuit.num_observables
    det_m = np.stack(sig_det, axis=1) if Fm else np.zeros((D, 0), dtype=np.uint8)
    obs_m = np.stack(sig_obs, axis=1) if Fm else np.zeros((L, 0), dtype=np.uint8)
    return DetectorErrorModel(
        sparse.csr_matrix(det_m.astype(np.uint8)),
        sparse.csr_matrix(obs_m.astype(np.uint8)),
        np.asarray(merged_p),
    )
