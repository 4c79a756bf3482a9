"""exp_ldpc_tpu_torch — the PyTorch/CUDA port of ``exp_ldpc_tpu``.

The JAX package beside it is the reference; this package mirrors its module
paths (``decoders/spacetime_bp.py`` is the counterpart of
``exp_ldpc_tpu/decoders/spacetime_bp.py``, and so on) and never imports
JAX, nor anything of the JAX package: the host-only modules (``core``,
``codes/``, ``circuits/``, ``utils/gf2``, ``utils/fields``, ``native/``,
the Tanner tables, the spacetime codes, OSD, the DEM tools and the CPU
sampler) are the port's own copies, kept equal to their originals by
``tests/test_torch_host_copies.py``, so the port runs where no
``exp_ldpc_tpu/`` exists.  Every TPU kernel is a CUDA C++ kernel for Hopper
under ``csrc/``, built with ``nvcc`` at first use; each has a plain PyTorch
version that the CPU runs.
"""
