"""Pauli-frame sampler on a PyTorch device.

Counterpart of ``exp_ldpc_tpu/sampler/device.py`` with the semantics of
the CPU oracle ``sampler/reference.py::FrameSampler`` (see that module for
the frame algebra).  Frames are (Q, S) uint8 bit planes with the shot axis
last; every gate and noise channel of a ``ParsedCircuit`` op list is one or
two indexed plane updates.  The REPEAT body runs as a Python loop over the
same op tables, so a round count costs no rebuild.

Noise probabilities are a device tensor (``ParsedCircuit.noise_args()``
order), so rebinding a sweep point rebuilds nothing.  Randomness comes from
an explicit ``torch.Generator`` on the sampler's device: each channel draws
``torch.rand(..) < p`` exactly where the JAX sampler draws a Bernoulli.
The two samplers give different bits from the same seed; they agree in
distribution.  The JAX sampler is XLA, with no Pallas kernel, so this stays
plain PyTorch on the card.
"""
from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

from ..circuits.ir import parse_circuit
from ..convert import DeviceOp, circuit_ops, noise_args
from ..utils.device import DeviceLike, resolve_device
from ..utils.observability import span

__all__ = ["build_record_sampler", "DeviceSampler"]


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


def build_record_sampler(circuit, shots: int, device: DeviceLike = "cuda"
                         ) -> Callable[[torch.Generator, torch.Tensor], torch.Tensor]:
    """Sampling function for a fixed circuit STRUCTURE:
    ``(generator, noise_args) -> (shots, M) uint8 record`` on ``device``,
    where ``noise_args`` is the f32 vector of :func:`convert.noise_args`.
    Record layout as the JAX sampler: rounds of [x_checks..., z_checks...]
    then the data readout."""
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
