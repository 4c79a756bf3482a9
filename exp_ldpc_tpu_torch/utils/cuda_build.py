"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``exp_ldpc_tpu_torch/csrc/`` exposes a plain C
interface.  At first use it is compiled with ``nvcc`` for Hopper
(``sm_90a``) into ``build/exp_ldpc_tpu_torch/`` at the repository root,
under a file name that carries the source hash (a changed source rebuilds),
and loaded with ``ctypes``.  Nothing here runs at import time: the CPU
tests import every module on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence

__all__ = ["CudaKernel"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "exp_ldpc_tpu_torch"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no a*b+c contraction: the kernels round exactly where their plain
    # PyTorch versions do
    "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


class CudaKernel:
    """One ``.cu`` file with a C entry point, built on first use.

    ``launches`` counts kernel launches made through :meth:`launch`; a run
    that claims to have used the kernel resets it before and reads it after.
    """

    def __init__(self, source: str, entry: str, argtypes: Sequence):
        self.source = _CSRC / source
        self.entry = entry
        self.argtypes = list(argtypes)
        self.launches = 0
        self.build_seconds: Optional[float] = None
        self.build_log = ""
        self._fn = None

    def build(self):
        """Compile (if the hashed library is missing) and load; returns the C function."""
        if self._fn is not None:
            return self._fn
        # the shared headers are part of every kernel's source
        src = self.source.read_bytes() + b"".join(
            h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
        tag = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
        so_path = BUILD_DIR / f"{self.source.stem}_{tag}.so"
        t0 = time.perf_counter()
        if not so_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as td:
                tmp = Path(td) / so_path.name
                cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(self.source)]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                self.build_log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed for {self.source.name}:\n{self.build_log}")
                os.replace(tmp, so_path)
        self.build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(so_path))
        fn = getattr(lib, self.entry)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn
        return fn

    def launch(self, *args) -> None:
        """Call the entry point (which launches on the given stream); raise
        on a nonzero ``cudaGetLastError`` code."""
        fn = self.build()
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{self.entry} launch failed with CUDA error {rc}")
        self.launches += 1
