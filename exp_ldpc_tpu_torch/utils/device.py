"""Explicit device resolution for the port.

Every entry point of the port takes a ``device`` argument, ``"cuda"`` by
default; this module turns it into a ``torch.device`` and refuses to carry
on on the CPU when a card was asked for: the CPU (where each kernel is
replaced by its plain version) runs only when asked for by name.  Parity products such as ``readout @ Hz.T mod 2`` are float
matrix products of 0/1 values that must be exact, so TF32 is switched off
for matrix products and convolutions when the module is imported.
"""
from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike) -> torch.device:
    """``"cuda"``/``"cpu"`` (or a ``torch.device``) -> ``torch.device``;
    ``"cuda"`` without a card raises instead of falling back."""
    if device is None:
        raise TypeError("device is required: pass 'cuda', or 'cpu' for the plain versions")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device is present")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
