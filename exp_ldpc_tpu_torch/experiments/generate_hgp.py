"""HGP code + circuit generator CLI.

Behavioral parity with ``reference/scripts/generate_hgp_code.py``:
same arguments and outputs (qecc code file + Stim-text circuit file).
"""
from __future__ import annotations

import sys
from argparse import ArgumentParser
from pathlib import Path

from ..circuits.noise import trivial_noise
from ..circuits.storage_sim import build_storage_simulation
from ..codes.hgp import biregular_hgp
from ..codes.io import write_quantum_code

__all__ = ["main"]


def main(argv=None):
    parser = ArgumentParser(
        description="Generate a (dv, dc)-biregular hypergraph product code and its "
        "syndrome-extraction circuit. n = nv^2 + (nv*dv/dc)^2 qubits."
    )
    parser.add_argument("dc", type=int, help="check vertex degree")
    parser.add_argument("dv", type=int, help="data vertex degree")
    parser.add_argument("nv", type=int, help="number of data vertices in the classical graph")
    parser.add_argument("--girth_bound", type=int, default=None,
                        help="remove cycles of length <= girth_bound from the classical graph")
    parser.add_argument("--girth_bound_patience", type=int, default=10000)
    parser.add_argument("--rounds", type=int, default=1, help="rounds of syndrome extraction")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--save_code", type=Path, default=None, help="write the qecc code file here")
    parser.add_argument("--save_circuit", type=Path, default=None, help="write the circuit file here")
    parser.add_argument("--compute_logicals", action="store_true",
                        help="compute logical operators (O(n^3) bit-packed homology)")
    args = parser.parse_args(argv)

    code = biregular_hgp(
        args.nv,
        args.dv,
        args.dc,
        seed=args.seed,
        compute_logicals=args.compute_logicals,
        girth_bound=args.girth_bound,
        girth_bound_patience=args.girth_bound_patience,
    )

    if args.save_code is not None:
        with args.save_code.open("w") as f:
            write_quantum_code(f, code)
    else:
        write_quantum_code(sys.stdout, code)

    if args.save_circuit is not None:
        sim = build_storage_simulation(args.rounds, trivial_noise(), code)
        with args.save_circuit.open("w") as f:
            f.write("\n".join(sim.circuit))
            f.write("\n")


if __name__ == "__main__":
    main()
