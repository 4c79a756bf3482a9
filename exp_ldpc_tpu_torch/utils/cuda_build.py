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
from typing import NamedTuple, Optional, Sequence

__all__ = ["CudaKernel", "RowShotPlan", "row_shot_plan", "aligned"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "exp_ldpc_tpu_torch"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no a*b+c contraction: the kernels round exactly where their plain
    # PyTorch versions do
    "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


ROW_THREADS = 256    # csrc/vec_io.cuh: threads per block of the row x shot kernels
_BLOCKS_PER_SM = 32  # grid cap; past it a thread takes several items (grid-stride loop)


class RowShotPlan(NamedTuple):
    """Launch of one phase of a row x shot kernel (K3, K4): ``vec``
    consecutive shots per thread, ``items`` = rows x (shots / vec) work
    items, rows outermost, walked by ``blocks`` blocks of ``ROW_THREADS``
    threads in a grid-stride loop (``csrc/vec_io.cuh::RowItems``): thread t
    takes items t, t + blocks*ROW_THREADS, ...; item i is row
    ``i // (shots // vec)``, shots ``(i % (shots // vec)) * vec`` on."""

    vec: int
    items: int
    blocks: int


def row_shot_plan(rows: int, shots: int, vecs: Sequence[int], sm_count: int) -> RowShotPlan:
    """The lane width is the first of ``vecs`` (the widths the phase is
    compiled for, widest first) that divides ``shots``, else 1: no item has
    a ragged tail, and an odd shot count runs one shot per thread.  The grid
    covers the items once, up to ``_BLOCKS_PER_SM`` blocks per SM."""
    vec = next((v for v in vecs if shots % v == 0), 1)
    items = rows * (shots // vec)
    if items >= 2**31:
        raise ValueError(f"{rows} rows x {shots} shots exceed the kernels' 32-bit work list")
    blocks = max(1, min(-(-items // ROW_THREADS), _BLOCKS_PER_SM * sm_count))
    return RowShotPlan(vec, items, blocks)


def aligned(*tensors, nbytes: int = 16) -> bool:
    """Whether every tensor starts on an ``nbytes`` boundary (the widest
    access of the row x shot kernels)."""
    return all(t.data_ptr() % nbytes == 0 for t in tensors)


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

    ``launches`` counts calls of the entry point made through
    :meth:`launch` (an entry point may enqueue several grids: K4's two
    phases of an iteration, all iterations of a K3 decode); a run that
    claims to have used the kernel resets it before and reads it after.
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
