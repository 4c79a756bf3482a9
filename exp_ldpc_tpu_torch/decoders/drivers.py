"""Decode-mode drivers of the port.

Counterpart of ``exp_ldpc_tpu/decoders/drivers.py`` for the three BP+OSD
modes (``bposd``: BP+OSD on the full spacetime matrix;
``bposd_single_shot``: per-round (H|I) BP+OSD with an accumulated
correction, then the final round; ``bposd_hybrid``: spacetime BP, then
BP+OSD of the final round) and the CLI helpers.  The other modes and
``run_simulation`` are not ported yet (ROADMAP.md, Queue 1).  Priors follow the
reference: data columns get ``data_prior``, measurement-error columns
``meas_prior``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..codes.io import read_quantum_code
from ..utils.device import DeviceLike, resolve_device
from .bposd import BPOSDDecoder
from .select import make_spacetime_bp_decoder, qc_kwargs_for_code, qc_kwargs_single_shot
from .spacetime import SpacetimeCode, SpacetimeCodeSingleShot

__all__ = ["BPOSDCorrect", "BPOSDCorrectSingleShot", "BPOSDHybridCorrect", "add_bposd_args",
           "unpack_bposd_args", "load_code", "spacetime_prior"]


def spacetime_prior(spacetime, data_prior: float, meas_prior: float) -> np.ndarray:
    """Per-column error probabilities of a ``SpacetimeCode``: data columns
    ``data_prior``, measurement-error columns ``meas_prior``."""
    prior = np.zeros(spacetime.spacetime_check_matrix.shape[1])
    prior[: spacetime._datablock_size] = data_prior
    prior[spacetime._datablock_size:] = meas_prior
    return prior


_BP_KEYS = ("max_iter", "bp_method", "ms_scaling_factor")
_OSD_KEYS = ("osd_method", "osd_order")


def _check_options(driver: str, bp_osd_options: Dict) -> None:
    unknown = set(bp_osd_options) - set(_BP_KEYS) - set(_OSD_KEYS)
    if unknown:
        raise ValueError(f"{driver}: unsupported options {sorted(unknown)}")


class BPOSDCorrect:
    """BP+OSD on the full spacetime matrix: BP on ``device`` (kernel chosen
    by :func:`.select.make_spacetime_bp_decoder`), OSD on the host."""

    def __init__(self, code, rounds: int, bp_osd_options: Dict,
                 priors: Tuple[float, float], basis: str = "z", device: DeviceLike = "cuda"):
        _check_options("BPOSDCorrect", bp_osd_options)
        data_prior, meas_prior = priors
        self._checks = code.checks.x if basis == "x" else code.checks.z
        self._spacetime_code = SpacetimeCode(self._checks, rounds)
        bp = make_spacetime_bp_decoder(
            self._checks, rounds, device=resolve_device(device),
            channel_probs=spacetime_prior(self._spacetime_code, data_prior, meas_prior),
            **{k: v for k, v in bp_osd_options.items() if k in _BP_KEYS},
        )
        self._bpd = BPOSDDecoder(
            bp=bp, H=self._spacetime_code.spacetime_check_matrix.tocsr(),
            osd_method=bp_osd_options.get("osd_method", "osd_cs"),
            osd_order=bp_osd_options.get("osd_order", 7),
        )

    def readout_correction_batch(self, history: np.ndarray, readout: np.ndarray) -> np.ndarray:
        """history (S, rounds, r), readout (S, n) -> final-round correction (S, n)."""
        syndromes = self._spacetime_code.syndrome_from_history_batch(history, readout)
        correction = self._bpd.decode_batch(syndromes)
        return self._spacetime_code.final_correction(correction)


class BPOSDCorrectSingleShot:
    """Per-round (H|I) BP+OSD with an accumulated correction, then BP+OSD of
    the final round on H (JAX ``drivers.py:83-120``).  The flat BP of both
    decoders is chosen by :func:`.select.make_bp_decoder`: kernel K1 past
    the crossover on a CUDA device (HGP-225's (H|I) and H both are)."""

    def __init__(self, code, rounds: int, bp_osd_options: Dict,
                 priors: Tuple[float, float], basis: str = "z", device: DeviceLike = "cuda"):
        _check_options("BPOSDCorrectSingleShot", bp_osd_options)
        dev = resolve_device(device)
        data_prior, meas_prior = priors
        self._rounds = rounds
        self._checks = code.checks.x if basis == "x" else code.checks.z
        self._Hd = self._checks.toarray().astype(np.int64)
        self._spacetime_code = SpacetimeCodeSingleShot(self._checks)
        self._bpd_single_shot = BPOSDDecoder.from_check_matrix(
            self._spacetime_code.spacetime_check_matrix,
            channel_probs=spacetime_prior(self._spacetime_code, data_prior, meas_prior),
            **qc_kwargs_single_shot(code, sector=basis), **bp_osd_options, device=dev)
        self._bpd_final_round = BPOSDDecoder.from_check_matrix(
            self._checks, error_rate=data_prior, **qc_kwargs_for_code(code, sector=basis),
            **bp_osd_options, device=dev)

    def readout_correction_batch(self, history: np.ndarray, readout: np.ndarray) -> np.ndarray:
        """history (S, rounds, r), readout (S, n) -> final-round correction (S, n)."""
        Hd = self._Hd
        acc = np.zeros_like(readout, dtype=np.int64)
        for t in range(self._rounds):
            syndrome = ((acc @ Hd.T) % 2 + history[:, t]) % 2
            st_correction = self._bpd_single_shot.decode_batch(syndrome)
            acc = (acc + self._spacetime_code.final_correction(st_correction)) % 2
        syndrome = (((acc + readout) % 2) @ Hd.T) % 2
        final = self._bpd_final_round.decode_batch(syndrome)
        return (final + acc) % 2


class BPOSDHybridCorrect:
    """Plain spacetime BP (kernel chosen by
    :func:`.select.make_spacetime_bp_decoder`), then BP+OSD of the final
    round on H (JAX ``drivers.py:124-158``; flat BP chosen by
    :func:`.select.make_bp_decoder`)."""

    def __init__(self, code, rounds: int, bp_osd_options: Dict,
                 priors: Tuple[float, float], basis: str = "z", device: DeviceLike = "cuda"):
        _check_options("BPOSDHybridCorrect", bp_osd_options)
        dev = resolve_device(device)
        data_prior, meas_prior = priors
        self._checks = code.checks.x if basis == "x" else code.checks.z
        self._HdT = self._checks.T.toarray().astype(np.int64)
        self._spacetime_code = SpacetimeCode(self._checks, rounds)
        self._bpd = make_spacetime_bp_decoder(
            self._checks, rounds, device=dev,
            channel_probs=spacetime_prior(self._spacetime_code, data_prior, meas_prior),
            **{k: v for k, v in bp_osd_options.items() if k in _BP_KEYS})
        self._bpd_final_round = BPOSDDecoder.from_check_matrix(
            self._checks, error_rate=data_prior, **qc_kwargs_for_code(code, sector=basis),
            **bp_osd_options, device=dev)

    def readout_correction_batch(self, history: np.ndarray, readout: np.ndarray) -> np.ndarray:
        """history (S, rounds, r), readout (S, n) -> final-round correction (S, n)."""
        syndromes = self._spacetime_code.syndrome_from_history_batch(history, readout)
        correction = self._bpd.decode_batch(syndromes)[0]
        bp_corr = self._spacetime_code.final_correction(correction).astype(np.int64)
        syndrome = (((bp_corr + readout) % 2) @ self._HdT) % 2
        final = self._bpd_final_round.decode_batch(syndrome)
        return (final + bp_corr) % 2


def add_bposd_args(parser):
    """BP+OSD CLI arguments (same surface as the JAX package)."""
    parser.add_argument(
        "--bposd_max_iter", type=lambda x: int(x) if x is not None else None,
        help="BP iteration cap (defaults to the code's qubit count)", default=None)
    parser.add_argument(
        "--bposd_bp_method", choices=["ps", "ms", "msl"],
        help="BP update rule: product-sum, min-sum, or log-domain min-sum", default="ps")
    parser.add_argument(
        "--bposd_ms_scaling_factor", type=float,
        help="min-sum scaling alpha; 0 selects the adaptive 1-2^-t schedule", default=0)
    parser.add_argument(
        "--bposd_osd_method", choices=["osd_e", "osd_cs", "osd0"],
        help="OSD post-processing variant", default="osd_cs")
    parser.add_argument("--bposd_osd_order", type=int,
                        help="OSD combination-sweep / exhaustion depth", default=7)


def unpack_bposd_args(parsed_args, code) -> Dict:
    """CLI arguments -> decoder options dict."""
    return {
        "max_iter": parsed_args.bposd_max_iter
        if parsed_args.bposd_max_iter is not None else code.checks.num_qubits,
        "bp_method": parsed_args.bposd_bp_method,
        "ms_scaling_factor": parsed_args.bposd_ms_scaling_factor,
        "osd_method": parsed_args.bposd_osd_method,
        "osd_order": parsed_args.bposd_osd_order,
    }


def load_code(args):
    """Load and validate a code file."""
    with args.code.open() as code_file:
        return read_quantum_code(code_file, validate_stabilizer_code=True)
