"""CPU Pauli-frame sampler — the statistical oracle.

Fills the role Stim's C++ ``compile_sampler()`` plays for the reference
(``reference/python/qldpc/misc/_experiment.py:193-197``), implemented
from scratch as a numpy Pauli-frame simulator.  Semantics:

The frame (fx, fz) per (shot, qubit) tracks the Pauli difference between the
noisy run and a fixed noiseless reference run; for the stabilizer circuits
this framework emits (R*/M*/MR*/CX/CZ + Pauli channels) the all-zero
reference record is exact, because every deterministic measurement outcome in
the noiseless circuit is 0 and all non-deterministic outcomes receive their
physical randomness from frame randomization at resets:

  * reset in basis b clears the frame component that anticommutes with the
    post-reset state and *randomizes* the unobservable component (RZ: fx<-0,
    fz<-random; RX: fz<-0, fx<-random) — this injected randomness propagates
    through the Cliffords and reproduces the correct joint distribution of
    non-deterministic measurements (e.g. first-round X-syndromes of a |0...0>
    product state are uniformly random but consistent across rounds);
  * measurement in basis b reads the anticommuting component (MZ reads fx,
    MX reads fz), XORs in the measurement-flip noise, then randomizes the
    commuting component (measurement collapse decorrelates it);
  * CX: fx_t ^= fx_c, fz_c ^= fz_t;  CZ: fz_a ^= fx_b, fz_b ^= fx_a;
  * DEPOLARIZE1(p): with prob p apply a uniform non-identity Pauli;
    DEPOLARIZE2(p): uniform non-identity 2-qubit Pauli; X/Y/Z_ERROR(p).

Validated by analytic invariants (noiseless => all detectors/observables 0),
hand-computed small cases, and statistical agreement with the device sampler
(tests/test_sampler.py).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..circuits.ir import ParsedCircuit, parse_circuit

__all__ = ["FrameSampler", "sample_circuit"]


class FrameSampler:
    """Batch Pauli-frame sampler over a parsed circuit."""

    def __init__(self, circuit, seed: Optional[int] = None):
        if not isinstance(circuit, ParsedCircuit):
            circuit = parse_circuit(circuit)
        self.circuit = circuit
        self._rng = np.random.default_rng(seed)

    def sample(self, shots: int, *, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """Sample the measurement record; returns uint8 (shots, num_measurements)."""
        c = self.circuit
        rng = rng or self._rng
        fx = np.zeros((shots, c.num_qubits), dtype=np.uint8)
        fz = np.zeros((shots, c.num_qubits), dtype=np.uint8)
        record = np.zeros((shots, c.num_measurements), dtype=np.uint8)

        def bern(p: float, size) -> np.ndarray:
            if not p:
                return np.zeros(size, dtype=np.uint8)
            return (rng.random(size) < p).astype(np.uint8)

        def rand_bits(size) -> np.ndarray:
            return rng.integers(0, 2, size=size, dtype=np.uint8)

        meas_base = 0
        # correlated-chain state: 1 where some member of the current
        # CORRELATED_ERROR chain already fired for that shot
        chain = np.zeros(shots, dtype=np.uint8)
        for op in c.flat_ops():
            t = op.targets
            name = op.name
            if name == "RZ":
                fx[:, t] = 0
                fz[:, t] = rand_bits((shots, t.size))
            elif name == "RX":
                fz[:, t] = 0
                fx[:, t] = rand_bits((shots, t.size))
            elif name in ("MZ", "MRZ"):
                p = op.arg or 0.0
                out = fx[:, t] ^ bern(p, (shots, t.size))
                record[:, meas_base : meas_base + t.size] = out
                meas_base += t.size
                if name == "MRZ":
                    fx[:, t] = 0
                fz[:, t] = rand_bits((shots, t.size))
            elif name in ("MX", "MRX"):
                p = op.arg or 0.0
                out = fz[:, t] ^ bern(p, (shots, t.size))
                record[:, meas_base : meas_base + t.size] = out
                meas_base += t.size
                if name == "MRX":
                    fz[:, t] = 0
                fx[:, t] = rand_bits((shots, t.size))
            elif name == "CX":
                ctrl, tgt = t[0::2], t[1::2]
                fx[:, tgt] ^= fx[:, ctrl]
                fz[:, ctrl] ^= fz[:, tgt]
            elif name == "CZ":
                a, b = t[0::2], t[1::2]
                za = fz[:, a] ^ fx[:, b]
                zb = fz[:, b] ^ fx[:, a]
                fz[:, a] = za
                fz[:, b] = zb
            elif name == "DEPOLARIZE1":
                e = bern(op.arg, (shots, t.size))
                k = rng.integers(1, 4, size=(shots, t.size), dtype=np.uint8)
                fx[:, t] ^= e & (k & 1)
                fz[:, t] ^= e & ((k >> 1) & 1)
            elif name == "DEPOLARIZE2":
                a, b = t[0::2], t[1::2]
                e = bern(op.arg, (shots, a.size))
                k = rng.integers(1, 16, size=(shots, a.size), dtype=np.uint8)
                fx[:, a] ^= e & (k & 1)
                fz[:, a] ^= e & ((k >> 1) & 1)
                fx[:, b] ^= e & ((k >> 2) & 1)
                fz[:, b] ^= e & ((k >> 3) & 1)
            elif name == "X_ERROR":
                fx[:, t] ^= bern(op.arg, (shots, t.size))
            elif name == "Z_ERROR":
                fz[:, t] ^= bern(op.arg, (shots, t.size))
            elif name == "Y_ERROR":
                e = bern(op.arg, (shots, t.size))
                fx[:, t] ^= e
                fz[:, t] ^= e
            elif name in ("CORRELATED_ERROR", "ELSE_CORRELATED_ERROR"):
                # stim chain semantics: the whole Pauli product fires with
                # prob p per shot; an ELSE only where nothing earlier in the
                # chain fired (its Bernoulli draw is independent, then masked)
                draw = bern(op.arg, shots)
                if name == "CORRELATED_ERROR":
                    fired = draw
                    chain = fired.copy()
                else:
                    fired = draw & (1 - chain)
                    chain |= fired
                paulis = np.asarray(op.paulis)
                xsel = (paulis == 1) | (paulis == 2)
                zsel = (paulis == 2) | (paulis == 3)
                if xsel.any():
                    fx[:, t[xsel]] ^= fired[:, None]
                if zsel.any():
                    fz[:, t[zsel]] ^= fired[:, None]
            elif name == "PAULI_CHANNEL_1":
                # one of X/Y/Z with DISJOINT probabilities (px, py, pz)
                px, py, pz = (float(v) for v in op.args)
                u = rng.random((shots, t.size))
                fx[:, t] ^= (u < px + py).astype(np.uint8)
                fz[:, t] ^= ((u >= px) & (u < px + py + pz)).astype(np.uint8)
            elif name == "PAULI_CHANNEL_2":
                # one of the 15 two-qubit Paulis, Stim parameter order
                # IX IY IZ XI XX XY XZ YI YX YY YZ ZI ZX ZY ZZ
                a, b = t[0::2], t[1::2]
                u = rng.random((shots, a.size))
                cum = np.concatenate([[0.0], np.cumsum(op.args)])
                # parameter k (1-based) is the pair with code 4*A + B = k,
                # A/B in (0=I, 1=X, 2=Y, 3=Z); region 16 = identity
                region = np.searchsorted(cum, u, side="right")
                pa, pb = region // 4, region % 4
                hit = region <= 15
                fx[:, a] ^= (hit & ((pa == 1) | (pa == 2))).astype(np.uint8)
                fz[:, a] ^= (hit & ((pa == 2) | (pa == 3))).astype(np.uint8)
                fx[:, b] ^= (hit & ((pb == 1) | (pb == 2))).astype(np.uint8)
                fz[:, b] ^= (hit & ((pb == 2) | (pb == 3))).astype(np.uint8)
            else:  # pragma: no cover
                raise ValueError(f"unsupported op {name}")
        assert meas_base == c.num_measurements
        return record

    def sample_detectors(self, shots: int, append_observables: bool = False, **kw) -> np.ndarray:
        """Sample detector bits (and optionally observable bits appended),
        mirroring stim's ``compile_detector_sampler`` interface used at
        ``misc/_experiment.py:192-194``."""
        record = self.sample(shots, **kw)
        det = (record @ self.circuit.detector_matrix().T.toarray()) % 2
        if append_observables:
            obs = (record @ self.circuit.observable_matrix().T.toarray()) % 2
            det = np.concatenate([det, obs], axis=1)
        return det.astype(np.uint8)


def sample_circuit(circuit, shots: int, seed: Optional[int] = None) -> np.ndarray:
    return FrameSampler(circuit, seed=seed).sample(shots)
