"""Multi-process dry run of the data-sharded pipeline on ``torch.distributed``.

Counterpart of ``exp_ldpc_tpu/parallel/dcn_dryrun.py``.  Run one process
per rank:

    python -m exp_ldpc_tpu_torch.parallel.dcn_dryrun --init-method tcp://localhost:PORT \\
        --world-size 2 --rank K --backend gloo --device cpu

Each process joins the world, builds a (data = world size, model = 1) mesh,
runs the sample+decode pipeline of the JAX dry run (HGP
``biregular_hgp(6, 2, 3, seed=1)``, 2 rounds, p = 0.01, 8 BP iterations,
``shots_per_device`` shots per rank, rank k drawing from ``batch_seed(seed,
0, 0, k)``), and prints the counts summed over the data axis as one JSON
line.  Every rank prints the same counts, equal to the sum of one-process
runs with the same rank seeds (``tests/test_torch_shard_dist.py``).
"""
from __future__ import annotations

import argparse
import json
import sys

import torch
import torch.distributed as dist

__all__ = ["run_workload", "main"]


def run_workload(shots_per_device: int = 16, seed: int = 0, device: str = "cuda",
                 mesh=None, rank: int = 0):
    """The dry run's pipeline step for data rank ``rank``: (failures,
    shots, bp_unconverged), summed over ``mesh``'s data axis (this rank's
    own counts without a mesh)."""
    from ..circuits.noise import depolarizing_noise
    from ..codes.hgp import biregular_hgp
    from ..experiments.p_sweep import batch_seed
    from .pipeline import StorageDecodePipeline

    code = biregular_hgp(6, 2, 3, seed=1, compute_logicals=True)
    p = 0.01
    pipe = StorageDecodePipeline(
        code=code, rounds=2, noise_model=depolarizing_noise(p, p), data_prior=2 / 3 * p,
        meas_prior=2 / 3 * p, shots_per_device=shots_per_device, max_iter=8, mesh=mesh,
        device=device)
    gen = torch.Generator(device=pipe.device)
    gen.manual_seed(batch_seed(seed, 0, 0, rank))
    failures, shots, unconverged = pipe.run(gen)
    return int(failures), int(shots), int(unconverged)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--init-method", required=True, help="tcp://host:port of rank 0")
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--backend", choices=["gloo", "nccl"], required=True)
    ap.add_argument("--device", choices=["cpu", "cuda"], required=True)
    ap.add_argument("--shots-per-device", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from .mesh import init_distributed, make_mesh

    rank = init_distributed(args.init_method, args.world_size, args.rank, args.backend)
    try:
        mesh = make_mesh(device=args.device)
        failures, shots, unconverged = run_workload(args.shots_per_device, args.seed,
                                                    args.device, mesh, mesh.data_index)
        print(json.dumps({"process_id": rank, "num_processes": dist.get_world_size(),
                          "device": str(mesh.device), "failures": failures, "shots": shots,
                          "bp_unconverged": unconverged}), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
