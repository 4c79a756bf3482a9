"""Native (C++) kernel loader.

Compiles the GF(2) elimination kernels on first use into a per-version cache
and exposes them through ctypes.  Falls back silently to the pure-numpy
implementations in :mod:`exp_ldpc_tpu.utils.gf2` if no compiler is available
(the numpy path is the reference implementation; the native path must match
it bit-for-bit — tests/test_gf2.py runs both).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

_SRC = Path(__file__).with_name("gf2_kernels.cpp")
_lib = None
_tried = False


def _build_lib() -> Optional[ctypes.CDLL]:
    src = _SRC.read_text()
    tag = hashlib.sha256(src.encode()).hexdigest()[:16]
    cache_dir = Path(
        os.environ.get("EXP_LDPC_TPU_TORCH_CACHE", _SRC.parents[2] / "build" / "exp_ldpc_tpu_torch")
    )
    cache_dir.mkdir(parents=True, exist_ok=True)
    so_path = cache_dir / f"gf2_kernels_{tag}.so"
    if not so_path.exists():
        with tempfile.TemporaryDirectory() as td:
            tmp_so = Path(td) / "gf2_kernels.so"
            cmd = [
                "g++", "-O3", "-march=native", "-shared", "-fPIC",
                str(_SRC), "-o", str(tmp_so),
            ]
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp_so, so_path)
    lib = ctypes.CDLL(str(so_path))
    lib.gf2_row_reduce.restype = ctypes.c_longlong
    lib.gf2_row_reduce.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_void_p,
    ]
    lib.gf2_rank.restype = ctypes.c_longlong
    lib.gf2_rank.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
    ]
    lib.osd_batch.restype = ctypes.c_longlong
    lib.osd_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,  # H, r, n
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,    # syndromes, llrs, S
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # method, order, nthreads
        ctypes.c_void_p,                                         # out
    ]
    return lib


def get_gf2_lib() -> Optional[ctypes.CDLL]:
    """The compiled kernel library, or None if unavailable."""
    global _lib, _tried
    if not _tried:
        _tried = True
        if os.environ.get("EXP_LDPC_TPU_NO_NATIVE"):
            _lib = None
        else:
            try:
                _lib = _build_lib()
            except Exception:
                _lib = None
    return _lib
