"""exp_ldpc_tpu_torch — the PyTorch/CUDA port of ``exp_ldpc_tpu``.

The JAX package beside it is the reference; this package mirrors its module
paths (``decoders/spacetime_bp.py`` is the counterpart of
``exp_ldpc_tpu/decoders/spacetime_bp.py``, and so on) and never imports
JAX.  Host-only modules (codes, circuits, the CPU samplers, Tanner tables,
OSD) are shared with the JAX package through :mod:`._host`.  Every TPU
kernel on the ported path is a CUDA C++ kernel for Hopper under ``csrc/``,
built with ``nvcc`` at first use; each has a plain PyTorch version that the
CPU runs.
"""
