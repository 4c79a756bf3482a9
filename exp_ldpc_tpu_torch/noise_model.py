"""Module alias matching the reference's ``qldpc.noise_model`` surface."""
from .circuits.noise import (
    apply_noise_pred,
    circuit_noise,
    circuit_ticks,
    depolarizing_noise,
    get_two_qubit_targets,
    tokenize_line,
    trivial_noise,
)
from .core import NoiseRewriter

__all__ = [
    "trivial_noise",
    "depolarizing_noise",
    "circuit_noise",
    "apply_noise_pred",
    "circuit_ticks",
    "tokenize_line",
    "get_two_qubit_targets",
    "NoiseRewriter",
]
