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
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

__all__ = ["CudaKernel", "RowShotPlan", "row_shot_plan", "BSRPlan", "bsr_widths", "bsr_plan",
           "BSR_SHOT_ALIGN", "MAX_SLOTS", "WIDE_VECS", "BSR_ROUTES", "COOP_BLOCKS_PER_SM",
           "aligned", "ResidentPlan", "resident_plan", "StreamedPlan", "streamed_plan",
           "STREAMED_SHOT_ALIGN", "pad_shots", "resident_max_threads", "device_limits"]

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
    """Launch of one phase of a row x shot kernel (K1, K3, K4, K5): ``vec``
    consecutive shots per thread, ``items`` = rows x (shots / vec) work
    items, rows outermost, walked by ``blocks`` blocks of ``ROW_THREADS``
    threads in a grid-stride loop (``csrc/vec_io.cuh::RowItems``): thread t
    takes items t, t + blocks*ROW_THREADS, ...; item i is row
    ``i // (shots // vec)``, shots ``(i % (shots // vec)) * vec`` on.
    ``route`` names the check phase's instances of K3 and K4: "default"
    (registers) or "wide" (the two-pass scan past ``MAX_SLOTS`` slots)."""

    vec: int
    items: int
    blocks: int
    route: str = "default"


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


BSR_SHOT_ALIGN = 16   # K1/K5 pad a decode's shot axis to this multiple
# csrc/spacetime_bp.cuh: the widest check (K2 and K3: data and measurement
# slots together) of every kernel's register instances; wider checks take
# route "wide", the two-pass check phase, whose lane widths are WIDE_VECS
# (K1, K3, K4: 8 bf16 shots a lane at most; K2 and K6: one shot a thread).
MAX_SLOTS = 32
WIDE_VECS = (8, 4, 2)


class BSRPlan(NamedTuple):
    """Launch of one K1 or K5 decode (``csrc/bsr_bp.cu``,
    ``csrc/bsr_bp_int8.cu``): every array has ``shots`` columns (the
    caller's ``live`` shots, padded with all-zero syndromes to a multiple of
    ``BSR_SHOT_ALIGN``, so every row starts on a 16-byte boundary); the
    early exit's unit is ``shot_block`` shots, and ``groups`` blocks cover
    the padded axis (the columns of the kernels' ``gbad`` table).  The three
    phases of an iteration walk checks, variables and checks again.
    ``route`` "grids": one grid per phase; "coop" (K1 only): the whole
    decode in one cooperative launch of the largest of the three grids,
    the phases separated by grid-wide barriers; "wide": one grid per phase,
    the check phase in two passes over the slots, for checks of more than
    ``MAX_SLOTS`` slots (the register instances stop there)."""

    shots: int
    live: int
    shot_block: int
    groups: int
    checks: RowShotPlan
    variables: RowShotPlan
    parity: RowShotPlan
    route: str = "grids"


def bsr_widths(check_degree: int, var_degree: int, int8: bool = False):
    """The lane widths each phase of K1 (bf16) or K5 (int8) is compiled for,
    widest first (``csrc/bsr_bp.cu``, ``csrc/bsr_bp_int8.cu``: the kernels'
    instances).  Phase A keeps a check's messages of every owned shot in
    registers up to ``MAX_SLOTS`` slots: K1 4 shots a lane up to 16
    slots and 2 above, as K3; K5 the packed bytes, 16 shots up to 8 slots,
    8 up to 24, 4 above.  Wider checks take route "wide", which holds a
    few running values per shot whatever the degree: 16-byte accesses (K1
    8 shots a lane, K5 16).  Phase B holds up to 8 (or 24) edges: K1 8
    shots a lane up to 8 edges and 4 above, K5 16 and 8.  Phase C moves
    bytes: up to 16."""
    wide = check_degree > MAX_SLOTS
    if int8:
        va = ((16, 8, 4) if check_degree <= 8 or wide else (8, 4) if check_degree <= 24
              else (4,))
        vb = (8, 4) if 8 < var_degree <= 24 else (16, 8, 4)
        return va, vb, (16, 8, 4)
    va = WIDE_VECS if wide else (4, 2) if check_degree <= 16 else (2,)
    vb = (8, 4, 2) if var_degree <= 8 else (4, 2)
    return va, vb, (16, 8, 4, 2)


COOP_BLOCKS_PER_SM = 2   # csrc/bsr_bp.cu: __launch_bounds__(ROW_THREADS, 2) of the coop kernel
BSR_ROUTES = {"grids": 0, "coop": 1, "wide": 2}   # csrc/bsr_phases.cuh: BSR_GRIDS, ...


def bsr_plan(checks: int, variables: int, check_degree: int, var_degree: int, shots: int,
             shot_block: int, sm_count: int, int8: bool = False,
             coop: bool = False) -> BSRPlan:
    """Plan of a K1 or K5 decode of ``shots`` shots with exit blocks of
    ``shot_block`` (already resolved, ``bp_bsr._blocks``).  Each phase takes
    the widest of :func:`bsr_widths` that divides the shot block (the padded
    shot count is a multiple of all), else one shot a lane: no item
    straddles two exit blocks.  With ``coop`` (the caller can take K1's
    cooperative route: min-sum) the route is "coop" where the kernel has the
    instance (checks of 7 or 8 slots, variables of up to 8 edges, lane
    widths 4 / 8 / 16) and every phase's grid fits ``COOP_BLOCKS_PER_SM``
    blocks per SM at once, so all of them are resident together.  Checks of
    more than ``MAX_SLOTS`` slots take route "wide"."""
    if shots < 1 or shot_block < 1:
        raise ValueError(f"shots ({shots}) and shot_block ({shot_block}) must be positive")
    padded = -(-shots // BSR_SHOT_ALIGN) * BSR_SHOT_ALIGN
    va, vb, vc = (tuple(v for v in vecs if shot_block % v == 0)
                  for vecs in bsr_widths(check_degree, var_degree, int8))
    plan = BSRPlan(padded, shots, shot_block, -(-padded // shot_block),
                   row_shot_plan(checks, padded, va, sm_count),
                   row_shot_plan(variables, padded, vb, sm_count),
                   row_shot_plan(checks, padded, vc, sm_count))
    fits = max(plan.checks.blocks, plan.variables.blocks,
               plan.parity.blocks) <= COOP_BLOCKS_PER_SM * sm_count
    if check_degree > MAX_SLOTS:
        plan = plan._replace(route="wide")
    elif (coop and not int8 and check_degree in (7, 8) and var_degree <= 8 and fits
            and (plan.checks.vec, plan.variables.vec, plan.parity.vec) == (4, 8, 16)):
        plan = plan._replace(route="coop")
    return plan


class ResidentPlan(NamedTuple):
    """Launch of a whole-decode flat or spacetime BP kernel (K2, K6) on the
    route "resident": a block owns ``group`` consecutive shots and keeps all
    their messages and syndromes in dynamic shared memory for every
    iteration; each shared-memory row holds ``stride`` (>= group) shot
    slots; ``smem_bytes`` is the block's dynamic shared memory, the tables
    included when ``tables_smem``.

    ``wide``: checks of more than ``MAX_SLOTS`` slots take the two-pass
    check phase (route "wide"; the wrappers set it from the degree, the
    kernels' entry points refuse a mismatch)."""

    route: str
    group: int
    stride: int
    blocks: int
    threads: int
    tables_smem: bool
    smem_bytes: int
    wide: bool = False

    @property
    def label(self) -> str:
        """The route as ``KERNEL.routes`` counts it: "resident" or
        "resident_wide"."""
        return self.route + ("_wide" if self.wide else "")


STREAMED_SHOT_ALIGN = 4   # csrc/streamed_bp.cuh: the streamed route pads its shots to this multiple


class StreamedPlan(NamedTuple):
    """Launch of one K2 or K6 decode on the route "streamed" (one shot's
    state does not fit in shared memory): the messages live in device
    memory, ``shots`` columns wide (the caller's ``live`` shots padded with
    all-zero syndromes to a multiple of ``STREAMED_SHOT_ALIGN``, so every row
    starts on a 16-byte boundary), and each phase of an iteration is one grid
    over (row, shot vector) items (``csrc/streamed_bp.cuh``): ``checks``
    (every check, every round block for K2; its ``route`` "wide" past
    ``MAX_SLOTS`` slots), ``variables`` (K2: the measurement variables, then
    the data variables) and, once after the last iteration, ``parity``.
    The tables are read through the read-only cache."""

    shots: int
    live: int
    checks: RowShotPlan
    variables: RowShotPlan
    parity: RowShotPlan
    wide: bool = False
    route: str = "streamed"

    @property
    def label(self) -> str:
        """The route as ``KERNEL.routes`` counts it: "streamed" or
        "streamed_wide"."""
        return self.route + ("_wide" if self.wide else "")

    @property
    def launch_args(self) -> Tuple[int, int, int, int]:
        """The plan as the C entry points take it: the check grid's lane
        width and the blocks of the check, variable and parity grids (those
        two at 4 shots a lane)."""
        return self.checks.vec, self.checks.blocks, self.variables.blocks, self.parity.blocks


def streamed_plan(check_rows: int, var_rows: int, shots: int, width: int,
                  sm_count: int) -> StreamedPlan:
    """Plan of a streamed decode of ``shots`` shots over ``check_rows``
    checks (of ``width`` slots, K2's measurement slots included) and
    ``var_rows`` variables.  The check grid keeps a check's slots of every
    owned shot in registers: 4 shots a lane (16-byte f32 accesses) up to 16
    slots, 1 up to ``MAX_SLOTS`` (2 spilled registers and ran 23-31% slower
    on an H100 at the cyclic code's 24 and 26 slots); route "wide" holds a
    few running values per shot whatever the degree: 4.  The variable and
    parity grids take 4."""
    if shots < 1 or sm_count < 1:
        raise ValueError(f"shots ({shots}) and sm_count ({sm_count}) must be positive")
    padded = -(-shots // STREAMED_SHOT_ALIGN) * STREAMED_SHOT_ALIGN
    wide = width > MAX_SLOTS
    va = (4,) if wide or width <= 16 else (1,)
    return StreamedPlan(padded, shots,
                        row_shot_plan(check_rows, padded, va, sm_count)._replace(
                            route="wide" if wide else "default"),
                        row_shot_plan(var_rows, padded, (4,), sm_count),
                        row_shot_plan(check_rows, padded, (4,), sm_count), wide)


def pad_shots(x, shots: int):
    """``x`` (rows, S) as a contiguous (rows, ``shots``) tensor whose columns
    past S are zero (``x`` itself where it already is one, 16-byte aligned)."""
    import torch

    if x.shape[1] == shots and x.is_contiguous() and aligned(x):
        return x
    out = torch.zeros((x.shape[0], shots), dtype=x.dtype, device=x.device)
    out[:, :x.shape[1]] = x
    return out


def resident_max_threads(width: int) -> int:
    """Threads per block the resident kernels are compiled for
    (``csrc/resident_bp.cuh::ResidentThreads``): 1,024 for check widths up
    to 16 slots (64 registers a thread), 512 above (128)."""
    return 1024 if width <= 16 else 512


def resident_fit(per_shot_bytes: int, table_bytes: int, budget: int, fixed_bytes: int = 0,
                 pad: int = 0) -> Tuple[bool, int]:
    """(tables in shared memory, shots that fit) of one resident block in
    ``budget`` bytes: the tables go beside the shots where they fit beside
    one shot (of stride ``1 + pad``)."""
    def need(stride: int, tables: bool) -> int:
        return stride * per_shot_bytes + fixed_bytes + (table_bytes if tables else 0)

    tables = need(1 + pad, True) <= budget
    return tables, (budget - need(0, tables)) // per_shot_bytes - pad


def resident_plan(per_shot_bytes: int, table_bytes: int, shots: int, smem_optin: int,
                  sm_count: int, *, fixed_bytes: int = 0, width: int = 16,
                  blocks_per_sm: int = 1, threads: Optional[int] = None,
                  max_group: Optional[int] = None, pad: int = 0) -> Optional[ResidentPlan]:
    """Launch of a whole-decode kernel on the resident route, from its shapes.

    A block's dynamic shared memory is ``stride * per_shot_bytes +
    fixed_bytes`` plus ``table_bytes`` when the tables sit there too
    (``stride = group + pad``).  If one shot does not fit in
    ``smem_optin`` (the card's opt-in limit per block), there is none (None:
    the caller takes the streamed route, :func:`streamed_plan`).  Else, where the batch fits one wave of one block per SM,
    ``group`` is ``ceil(shots / sm_count)``, so a few hundred shots still
    spread over every SM, with the widest thread count of the check
    ``width`` (:func:`resident_max_threads`).  A larger batch runs
    ``blocks_per_sm`` blocks side by side on each SM (so one block's
    barrier waits overlap another's work), each in ``smem_optin //
    blocks_per_sm`` bytes with ``resident_max_threads // blocks_per_sm``
    threads, and ``group`` is as many shots as fit there (at most
    ``max_group``), evened out over the waves.  The tables go in shared
    memory when they fit beside one shot.  ``threads`` overrides the thread
    count (a multiple of 32, at most :func:`resident_max_threads`)."""
    if shots < 1 or sm_count < 1 or blocks_per_sm < 1:
        raise ValueError(f"shots ({shots}), sm_count ({sm_count}) and blocks_per_sm "
                         f"({blocks_per_sm}) must be positive")

    def need(stride: int, tables: bool) -> int:
        return stride * per_shot_bytes + fixed_bytes + (table_bytes if tables else 0)

    def fit(budget: int) -> Tuple[bool, int]:
        return resident_fit(per_shot_bytes, table_bytes, budget, fixed_bytes, pad)

    if need(1 + pad, False) > smem_optin:
        return None
    cap = resident_max_threads(width)
    tables, most = fit(smem_optin)
    per_sm = 1
    if shots > sm_count * most and blocks_per_sm > 1 and need(1 + pad, False) <= (
            smem_optin // blocks_per_sm):
        per_sm = blocks_per_sm
        tables, most = fit(smem_optin // per_sm)
    if max_group is not None:
        most = max(1, min(most, int(max_group)))
    slots = sm_count * per_sm
    waves = -(-shots // (slots * most))
    group = -(-shots // (slots * waves))
    width_threads = max(32, 32 * (cap // per_sm // 32))
    nthreads = width_threads if threads is None else max(32, min(cap, 32 * (int(threads) // 32)))
    return ResidentPlan("resident", group, group + pad, -(-shots // group), nthreads, tables,
                        need(group + pad, tables))


_LIMITS: Dict[int, Tuple[int, int]] = {}


def device_limits(kernel: "CudaKernel", device) -> Tuple[int, int]:
    """(opt-in shared memory per block in bytes, SM count) of a CUDA
    device, read once with ``cudaDeviceGetAttribute`` through ``kernel``'s
    library (``csrc/resident_bp.cuh::device_limits``)."""
    import torch

    idx = torch.cuda.current_device() if device.index is None else int(device.index)
    if idx not in _LIMITS:
        fn = kernel.symbol("device_limits", [ctypes.c_int, ctypes.c_void_p])
        out = (ctypes.c_int * 2)()
        rc = fn(idx, ctypes.cast(out, ctypes.c_void_p))
        if rc != 0:
            raise RuntimeError(f"cudaDeviceGetAttribute failed with CUDA error {rc}")
        _LIMITS[idx] = (int(out[0]), int(out[1]))
    return _LIMITS[idx]


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
    phases of an iteration, all iterations of a K3 decode), and ``routes``
    splits that count by the route the caller names (K2 and K6:
    "resident" or "streamed"; the other kernels have one, "default"); a run
    that claims to have used the kernel resets both (:meth:`reset_counts`)
    before and reads them after.
    """

    def __init__(self, source: str, entry: str, argtypes: Sequence):
        self.source = _CSRC / source
        self.entry = entry
        self.argtypes = list(argtypes)
        self.launches = 0
        self.routes: Dict[str, int] = {}
        self.build_seconds: Optional[float] = None
        self.build_log = ""
        self._fn = None
        self._lib = None

    def reset_counts(self) -> None:
        self.launches = 0
        self.routes = {}

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
        self._lib = lib
        fn = getattr(lib, self.entry)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn
        return fn

    def symbol(self, name: str, argtypes: Sequence):
        """Another C function of the same library (built on first use)."""
        self.build()
        fn = getattr(self._lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        return fn

    def launch(self, *args, route: str = "default") -> None:
        """Call the entry point (which launches on the given stream); raise
        on a nonzero ``cudaGetLastError`` code."""
        fn = self.build()
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{self.entry} launch failed with CUDA error {rc}")
        self.launches += 1
        self.routes[route] = self.routes.get(route, 0) + 1
