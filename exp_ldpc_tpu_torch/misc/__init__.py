"""Experiment-driver surface matching the reference's ``qldpc.misc`` (the
names and ``__all__`` of ``exp_ldpc_tpu/misc/__init__.py``)."""
from ..decoders.drivers import (
    BPDetectorCorrect,
    BPOSDCorrect,
    BPOSDCorrectSingleShot,
    BPOSDHybridCorrect,
    add_bposd_args,
    load_code,
    run_simulation,
    unpack_bposd_args,
)
from ..experiments.p_sweep import p_sweep, p_sweep_main, parse_sweep_spec

__all__ = ["p_sweep_main", "p_sweep", "parse_sweep_spec", "run_simulation",
           "BPOSDCorrect", "BPOSDCorrectSingleShot", "BPOSDHybridCorrect",
           "BPDetectorCorrect", "add_bposd_args", "unpack_bposd_args", "load_code"]
