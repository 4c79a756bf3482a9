"""The (data, model) process mesh on ``torch.distributed``.

Counterpart of ``exp_ldpc_tpu/parallel/mesh.py``.  JAX's mesh is a grid of
devices inside one SPMD program; here it is a grid of processes, one
device each, joined by :func:`init_distributed`:

  * ranks are laid out in order with the model axis fastest, rank = d *
    model + m, as the JAX package's ``make_mesh(..., devices=...)`` reshapes
    an explicit device list;
  * the data axis shards Monte-Carlo shots (``parallel/pipeline.py``); the
    model axis shards the checks of one decode
    (``decoders/bp_bsr_shard.py``, ``parallel/check_shard.py``);
  * each axis has its process group, over which the JAX ``psum`` becomes
    an ``all_reduce``.

``mesh=None`` everywhere in the port means one process and one device, and
no collective.  Nothing here reads the environment: the init method, the
world size and the rank are passed in, and so is the backend (``nccl``
for one card per process, ``gloo`` for the CPU, or for several ranks
sharing one card).
"""
from __future__ import annotations

import multiprocessing
import queue as _queue
import socket
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..utils.device import DeviceLike, resolve_device

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "init_distributed", "make_mesh", "free_port",
           "run_world", "all_reduce_sum", "all_gather_cols"]

DATA_AXIS = "data"
MODEL_AXIS = "model"


def init_distributed(init_method: str, world_size: int, rank: int, backend: str) -> int:
    """Join a ``torch.distributed`` world; returns this process's rank.

    Every argument is explicit (``init_method`` such as
    ``tcp://localhost:29500``).  A failure raises: carrying on alone would
    let every process run the whole workload and report it as its share.
    Joining the same world again is a no-op."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r} (gloo or nccl)")
    if dist.is_initialized():
        if dist.get_world_size() != world_size or dist.get_rank() != rank:
            raise RuntimeError(
                f"already in a world of {dist.get_world_size()} as rank {dist.get_rank()}, "
                f"asked for {world_size} as rank {rank}")
        return rank
    dist.init_process_group(backend=backend, init_method=init_method, world_size=world_size,
                            rank=rank)
    return dist.get_rank()


@dataclass(frozen=True, eq=False)
class Mesh:
    """This process's place in a (data, model) grid of ranks.

    ``shape[DATA_AXIS]`` and ``shape[MODEL_AXIS]`` as in JAX;
    ``coords`` = (data index, model index); ``data_group`` joins the ranks
    of this model index, ``model_group`` those of this data index; a group
    of one rank is ``None`` (no collective to run)."""

    shape: dict
    rank: int
    coords: tuple
    data_group: Optional[Any]
    model_group: Optional[Any]
    device: torch.device

    @property
    def data_index(self) -> int:
        return self.coords[0]

    @property
    def model_index(self) -> int:
        return self.coords[1]


def _rank_device(device: DeviceLike, rank: int) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        # one card per rank on a host; ranks beyond the card count share
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              device: DeviceLike = "cuda") -> Mesh:
    """The (data, model) mesh over the joined world.

    ``n_devices`` defaults to the world size and must equal it (every rank
    is one device of the mesh).  Without a joined world, only the
    one-device mesh exists.  ``device`` ``"cuda"`` gives rank r the card
    ``cuda:r mod card count``; ``"cpu"`` must be named."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs a world of {n} processes, not {world} "
                         "(init_distributed)")
    if model_parallel < 1 or n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    n_data = n // model_parallel
    data_group = model_group = None
    if world > 1:
        # every rank creates every group, in the same order
        for m in range(model_parallel):
            ranks = [d * model_parallel + m for d in range(n_data)]
            g = dist.new_group(ranks) if n_data > 1 else None
            if rank in ranks:
                data_group = g
        for d in range(n_data):
            ranks = [d * model_parallel + m for m in range(model_parallel)]
            g = dist.new_group(ranks) if model_parallel > 1 else None
            if rank in ranks:
                model_group = g
    return Mesh({DATA_AXIS: n_data, MODEL_AXIS: model_parallel}, rank,
                divmod(rank, model_parallel), data_group, model_group,
                _rank_device(device, rank))


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """In-place SUM over ``group``; a group of one rank (``None``) is a no-op."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_gather_cols(t: torch.Tensor, group) -> torch.Tensor:
    """(..., S_loc) blocks of the group's ranks, in rank order, concatenated
    along the last axis (the shot axis)."""
    if group is None:
        return t
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


def free_port() -> int:
    """A TCP port on localhost that is free now (for ``tcp://localhost:<port>``)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _world_entry(fn, rank, world, init_method, backend, args, queue, threads):
    if threads:
        torch.set_num_threads(threads)
    try:
        init_distributed(init_method, world, rank, backend)
        out = fn(rank, world, *args)
        queue.put((rank, True, out))
    except Exception:  # reported to the parent, which raises
        queue.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(fn: Callable, world_size: int, args: Sequence = (), backend: str = "gloo",
              timeout: float = 120.0, threads: Optional[int] = 1) -> List[Any]:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` fresh processes
    joined over ``tcp://localhost:<free port>``; returns the results in rank
    order.  ``fn`` and ``args`` must pickle (a module-level function).  A
    rank that raises, or a run past ``timeout`` seconds, kills every rank
    and raises here."""
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    init_method = f"tcp://localhost:{free_port()}"
    procs = [ctx.Process(target=_world_entry, daemon=True,
                         args=(fn, r, world_size, init_method, backend, tuple(args), queue,
                               threads))
             for r in range(world_size)]
    for p in procs:
        p.start()
    results: dict = {}
    try:
        deadline = time.monotonic() + timeout
        while len(results) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"run_world: {world_size} ranks did not finish in {timeout} s")
            try:
                rank, ok, out = queue.get(timeout=min(left, 1.0))
            except _queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"run_world: a rank exited with code {dead[0].exitcode}")
                continue
            if not ok:
                raise RuntimeError(f"run_world: rank {rank} failed:\n{out}")
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world_size)]
