"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # the full check, one card
    python3 chip_smoke.py --quick    # build + kernel parity at a small size only

Phases, in order; any failure raises and exits nonzero:
  1. versions and the card (``nvidia-smi`` name and power limit); the
     port's C++ GF(2)/OSD library must build and load (no silent numpy
     fallback on this machine);
  2. build kernels K1 (``csrc/bsr_bp.cu``: one grid per phase of an
     iteration, phase C in ``csrc/bsr_phases.cuh``), K2 (``csrc/stbp.cu``), K3
     (``csrc/stbsr.cu``: one grid per phase of an iteration, the phases in
     ``csrc/stbsr_phases.cuh``), K4 (``csrc/bsr_shard.cu``, phases in
     ``csrc/bsr_shard_phases.cuh``), K5 (``csrc/bsr_bp_int8.cu``) and K6
     (``csrc/bpflat.cu``) from source, one ``nvcc`` per source, all at once;
  3. K2 against its plain PyTorch version on the card, at a ragged shot
     count (685, the host redecode's size), 4,096 and the main path's
     16,384 shots, below the SM count (77: one shot per block) and ragged
     past one wave (5,001), all on the resident route (each block's shots
     in shared memory); 685 on the streamed route too; the gross code
     over 12 rounds (60 iterations, 4,096 shots); and the n = 10,000 HGP
     over 8 rounds (128 shots, 4 iterations), whose state does not fit
     shared memory: the streamed route.  Hard decisions, conv and iters
     equal, posteriors equal to 1e-6*max(1,|x|); each case prints its plan;
  4. K3 against its plain PyTorch version, at the same sizes and bounds:
     the device-side loop (one call per decode; 685 shots are padded to 688
     and run the vector paths like 4,096 and 16,384), fixed and with the
     early exit, at a batch where the exit never fires and at an easy one
     (p = 2e-4) where it fires before ``max_iter``; and single iterations
     of the kernels looped on the host at S = 97 and 685 as they are (one
     shot per thread: the scalar paths);
  5. the device sampler: noiseless circuit -> zero detectors; detector rates
     against the host oracle ``FrameSampler`` (whose ~10 s of host work runs
     in a thread beside phases 2-4);
  6. the main path: ``p_sweep(..., pipeline=...)`` on HGP-225, 4 rounds,
     min-sum 48 iterations, OSD-CS 7, at two grid points of
     ``artifacts/ler_hgp225_bposd_v5e.jsonl`` and at p = 0.006 (anchor:
     ``artifacts/pipeline_modes_jax_cpu.jsonl``, made by the JAX package on a
     CPU), each LER within 4 combined binomial sigma of its anchor, through
     the selection's kernels: K2 in the device step (fixed iterations), K3
     with its exit in the host redecode (whose BP+OSD asks the exit);
  7. the same pipeline on K3 (``bp_backend="stbsr"``, the JAX package's
     choice on a TPU);
  8. timings (CUDA events, median of 5 distinct-input runs): K2 at 16,384
     shots on both routes and at 685, the gross code over 12 rounds (16,384
     x 60), each with its plan; K3; the sampler; the ``bposd`` stages of
     the automatic pipeline (K2 in the device step) and of
     ``bp_backend="stbsr"`` (K3), in turns;
  9. K6 against its plain version on HGP-225's H and (H|I) at S = 685,
     4,096, 16,384, 77 and 5,001 (resident), 685 on the streamed route, and
     the n = 40,000 HGP (128 shots, 4 iterations: streamed), bounds as in
     phase 3;
 10. K1 against its plain version at the same codes and sizes, fixed and
     with the early exit per shot block; at S in {1, 77, 128, 300, 685} in
     shot blocks of 128 and 256 on a batch whose first 128 shots have
     all-zero syndromes (that block stops after one iteration, the next
     runs on); at the cyclic lifted product n = 4,862 (check degree 24);
     and at ``biregular_hgp(160, 3, 4)`` (>= 3,000 tiles: the regime of
     the rolled TPU kernel K1b, which K1 serves).  Every output equal,
     posteriors bit for bit; one K1 call per decode; each case prints its
     plan (padded shots, shot blocks, lane width and grid per phase);
 11. the single-shot and hybrid modes through ``p_sweep(...,
     pipeline=...)`` on ``artifacts/hgp225.qecc`` at p = 0.002 and 0.006,
     each LER within 4 combined binomial sigma of its row of
     ``artifacts/pipeline_modes_hgp225_v5e.csv`` (0.002) or
     ``artifacts/pipeline_modes_jax_cpu.jsonl`` (0.006); K6 in the device
     step and K1 in the host redecode, K2 and K3 in the hybrid's
     spacetime stages;
 12. timings of K1 and K6 against their plain versions (``bench_bp``'s
     configuration, 16,384 and 685 shots x 48 iterations; K1 also at the
     >= 3,000-tile code), beside K1's times before its redesign
     (``OLD_KERNEL_MS``), K6's streamed route at 16,384 and its plans, and
     the modes' stage split.

 13. K4 (``csrc/bsr_shard.cu``) against its plain version through the
     emulated check-partition decoder at ``biregular_hgp(20, 3, 4, seed=1)``
     (n = 625), D in {1, 2, 3}, S in {97, 685, 4,096} (the decoder pads 97
     and 685 to a multiple of 8: vector paths), min-sum at alpha 0.625,
     adaptive min-sum and sum-product, 24 iterations (bounds as in phase
     3); one iteration on ragged tensors of 97 shots (one shot per thread),
     partials stored and accumulated, equal to the plain version's; and at
     the capacity demo's full size (``shard_capacity.build``: n = 40,000,
     D = ``auto_num_shards`` (8), 128 shots, 32 iterations);
 14. the emulated check-partition decode on K4 against K1 at fixed
     iterations (the JAX contract): hard decisions and conv equal;
 15. the model axis's main path: ``shard_capacity``'s decode and checks at
     its full size (n = 40,000, D = 8, 128 shots, 32 iterations);
 16. the distributed path: two ranks in two processes on the one card
     (model axis 2, ``backend="gloo"``, which all-reduces CUDA tensors),
     whose hard decisions, conv flags and posteriors must equal the
     emulated D = 2 decode.  The ranks start right after the build and run
     beside phases 3-5 (their ~10 s are nearly all process start-up); the
     phase joins and checks them after phase 5;
 17. K3 against its plain version in the regime where the JAX package
     selects the rolled K3b (>= 64 BSR tiles): ``bench_stbsr.py``'s codes
     (the cyclic lifted product n = 4,862 and ``biregular_hgp(80, 3, 4,
     seed=7)`` n = 10,000), 8 rounds, 128 shots, 32 iterations; min-sum and
     sum-product at both; each compared decode is timed once;
 18. timings: K4 per decode iteration (all shards) and its plain version
     at the capacity and ``bench_bsr_shard`` (cyclic n = 4,862 in QC order,
     1,024 shots, D in {1, 2, 4}) shapes, beside K1 at the same shapes,
     each by ``shard_capacity.per_iter_slope`` (4 -> 12 iterations, best of
     2 distinct batches).


 19. K5 (int8 min-sum) against its plain version: posterior quanta, hard
     decisions, conv and iters EQUAL (integer arithmetic: max |delta| = 0),
     at HGP-225's H and (H|I), S = 685, 4,096 and 16,384, fixed and with the
     early exit per shot block, at phase 10's exit cases (S in {1, 77, 128,
     300, 685}, blocks of 128 and 256), and at the family benchmark's two codes
     (QC-LP [[1054,140]]; cyclic n = 4,862 in QC order; 1,024 shots, 32
     iterations); and ``int8_bp_core`` on the card against the numpy oracle;
 20. the code-family path: ``bench_large_codes.main`` rows
     ``qclp_1054_140/{base,bsr,bsr-int8,qc}`` and
     ``cyclic_lp_4862/{bsr,bsr-int8}`` at 1,024 shots x 32 iterations,
     p = 1e-3 (slope over 1 and 3 decodes, best of 3), K1 and K5 launched;
     the converged share of each ``bsr-int8`` row is not below its ``bsr``
     row's (less 0.02), and each kernel row's share agrees with the JAX
     package's row of ``artifacts/bp_families_v5e.jsonl`` within 4 combined
     binomial sigma (int8 converges more often than bf16 at the cyclic
     code, there as here);
 21. timings of K5 and K1 and their plain versions at those two codes
     (CUDA events, median of 3 distinct batches; the old kernels' times
     beside), and
     each kernel's bound:
     the larger of its bytes (inputs read once, outputs written once) over
     3.35 TB/s and its operations over 67 TFLOP/s, at the shape of its
     ``ms`` and of each ``ms_<tag>`` (with the early exit: the
     shot-iterations the timed batches needed);
 22. K1 and K5 against their plain versions at check degree 53: the fault
     matrix of HGP-225's 1-round circuit-noise detector error model (216 x
     1,518; built in a thread beside the kernel build), S = 97 and 4,096,
     48 iterations, min-sum and sum-product (K5: int8 min-sum), fixed and
     with the early exit: every decode takes route "wide" (the two-pass
     check phase) and equals its plain version bit for bit; timed at 4,096
     x 48 (``ms_dem_dc53``; also with ``--quick``, untimed); then K1
     against its plain version at the other matrices phase 23 decodes on
     K1, each at the shot count and with the options phase 23 gives it
     (all three built in a thread beside the kernel build): the 4-round
     phenomenological detector model of ``bpd_detector`` (864 x 4,014,
     check degree 23; 16,384 shots, 40 iterations, adaptive min-sum),
     ``sliding_window``'s window matrix (432 x 1,332) and its 4-round
     exact tail (540 x 1,557; 4,096 shots, 48 iterations, min-sum 0.625);
     min-sum with the run's scaling and sum-product, fixed and with the
     early exit, bit for bit; each must be the matrix the selection sends
     to K1 on the card (not with ``--quick``);
 23. the host path: ``p_sweep(..., pipeline=None)``, hence
     ``run_simulation``, in all seven modes on HGP-225 (the
     ``biregular_hgp(12, 3, 4, seed=0)`` object the anchors were made with:
     its logical representatives score the shots small-set-flip leaves
     unconverged), 4 rounds, the device sampler on the card, 16,384 shots a mode
     (``sliding_window``: 64 rounds, 4,096 shots, window 4, commit 2), each
     LER within 4 combined binomial sigma of its anchor (``bposd`` at p =
     3.4822e-3: ``ler_hgp225_bposd_v5e.jsonl``; the single-shot and hybrid
     modes at p = 0.002: ``pipeline_modes_hgp225_v5e.csv``; ``bpd_detector``,
     ``relay_bp`` and ``ssf_single_shot`` at p = 0.002:
     ``run_simulation_modes_jax_cpu.jsonl``, made by the JAX package on a
     CPU; ``sliding_window`` at p = 0.001: ``sliding_window_v5e.jsonl``),
     failures, shots/s and K1/K2/K3 launches printed per mode (every
     BP+OSD asks the early exit: the selection's K3 for the spacetime
     matrix, K1 for the flat ones); then
     ``bpd_detector`` under 1-round circuit noise (4,096 shots), whose fault
     checks of 53 slots send every K1 call down route "wide";
 24. route "wide" (checks of more than 32 slots) against the plain
     versions, 24 iterations, min-sum and sum-product, at the bounds of
     phase 3: at ``biregular_hgp(32, 16, 16, seed=0)`` (2,048 qubits, 1,024
     Z checks of degree 32) over 4 rounds, 1,024 shots, K3 (the ``bposd``
     device step; also at 97 shots, the host redecode's ragged size), K2
     on its streamed route (the hybrid device step: one shot's state is 655
     KB) and K6 on (H|I) (33 slots, the single-shot device step) on the
     streamed route (one shot would fit a resident block: K6's rule,
     ``bp_cuda.STREAMED_MAX_FIT``), and K1 on (H|I) at 97 shots (the
     single-shot host redecode); K2 (over 2 rounds) and K6 on the resident
     route "wide" at a random 60 x 300 matrix of 33-40 slot checks (no repo
     code with checks that wide fits several shots in shared memory); K4
     at phase 22's detector model (53 slots), D = 2 and 4; each wide shape
     timed once (K4 per iteration, ``per_iter_slope`` 2 -> 6) beside its
     plain version and its bound; then one ``p_sweep`` point per pipeline
     mode on the dense HGP (256 shots, p = 5e-4, OSD-0), each on its route
     "wide" (K3, K6 resident, K2 streamed), and the detector model's
     check-partition decode (``ShardedBSRDecoder.decode_batch``, D = 4,
     1,024 shots) with every K4 call on route "wide";
 25. the two-tier decode in ``experiments/bench_two_tier.py``'s regime
     (cyclic lifted product n = 4,862, 4 rounds, p = 2e-4, 4 batches of
     2,048 shots, 48 iterations; tier 1 = 8, cap 512): fixed and two-tier
     on the same seeds agree within max(3, 10%) in failures and
     unconverged shots, and each failure count within 4 combined binomial
     sigma of ``artifacts/two_tier_v5e.jsonl``'s 1,081 / 8,192; shots/s of
     both and the device step of both (median of 5 batches) beside the
     bound of each; K3 bit for bit against its plain version on the
     compacted 512-shot stage-2 decode (the selection takes K3 there: one
     shot of K2 does not fit shared memory); and the flagship ``bposd``
     point at p = 3.4822e-3 with ``tier1_iters=8`` (32,768 shots, on the
     selection's K2; K3 in the host redecode) on phase 6's anchor;
 26. the rounds axis: two gloo ranks on the card (started beside the
     parity phases), HGP-225 over 7 rounds (4 round blocks a rank), 2,048
     shots x 24 min-sum iterations, the halo rows staged through the host:
     sharded and unsharded decisions differ on at most 0.1% of converged
     shots, and every converged shot satisfies its syndrome;
 27. ``utils/observability.py::profiler_trace`` of one ``bposd`` device
     step (HGP-225, 4,096 shots, ``bp_backend="stbsr"``): the trace must
     name K3's kernels;
 28. ``experiments/validate_ler.py`` (its ``sweep`` and ``crosscheck``):
     phenomenological ``bp`` at p = 3.4822e-3, circuit ``bp`` at 5.2233e-4
     and circuit ``bposd`` at 2.2736e-4, 16,384 shots each (the artifacts
     hold 1,000,000 and 401,408), each LER within 4 combined binomial sigma
     of its row (``ler_hgp225_v5e.jsonl``, ``ler_hgp225_circuit_v5e.jsonl``,
     ``ler_hgp225_bposd_circuit_v5e.jsonl``); the ``bposd`` run's
     cross-check (2,000 host ``FrameSampler`` shots through
     ``BPOSDCorrect``) must agree; the selection's K2 (the device step)
     launched in each;
 29. ``experiments/bench_gross.py`` at its defaults (gross code x 12
     rounds, 20,000 shots x 60, grid (1e-3, 5e-3, 4)): K2; p = 2.924e-3 and
     5e-3 within 4 sigma of ``gross_memory_12r_v5e.jsonl`` (66 and 323 of
     50,000); shots/s printed;
 30. ``experiments/validate_dem.py`` on its default relay path at p =
     7.917e-4, the artifact's 8,192 samples in batches of 2,048 (the other
     options as default): the 4-round detector model (864 x 36,491, ~150 s of host
     Python) is built in a spawned process from the start of the run; the
     selection's stage 1 there is K1 on route "wide" (the JAX fit rule
     refuses K1 on a TPU), the only kernel of the run, which is checked;
     before the run K1 is held bit for bit to its plain version there, with
     stage 1's own decoder (min-sum, alpha 0, 48 iterations, the exit
     armed, and fixed) on two shot blocks, the first all zero; stage times
     printed; LER within 4 sigma of 69 / 8,192;
 31. ``experiments/demo_sliding_window.py`` at its defaults (64 and 128
     rounds x 512 shots): K1; each LER within 4 sigma of its row of
     ``sliding_window_v5e.jsonl`` (7 and 16 of 512); the walltime ratio
     printed;
 32. ``experiments/bench_osd_host.py`` at its defaults (the harvest on K2,
     host OSD rows; every OSD output satisfies its syndrome);
 33. ``experiments/bench_spacetime.py``: K6 (generic) and K2 (structured)
     first held to their plain versions on the benchmark's own first two
     batches (1,024 shots x 32 iterations, min-sum and sum-product; as
     ``_same``), then the benchmark and its plain versions, every time a
     slope (none an upper bound), no LER gate;
 34. ``experiments/bench_scaling.py`` on the one card: one row, K2;
 35. ``experiments/bench_stbsr.py --ler`` uncut (``ler_chain``: the cyclic
     lifted product n = 4,862 x 8 rounds, device sampler, K3 at 64 min-sum
     iterations with the global exit armed, 2,048 shots at p = 3e-4, 6e-4,
     1.2e-3): each failure count within 4 combined binomial sigma of its row
     of ``stbsr_ler_v5e.jsonl`` (603 / 830 / 1,105 of 2,048; its
     BP-unconverged counts printed beside), the LERs monotone, K3 once a
     point; then K3 held to its plain version on the p = 1.2e-3 point's
     syndromes (as ``_same``) and timed (median of the three points) beside
     its bound;
 36. the README quickstart as written, on the card: ``import
     exp_ldpc_tpu_torch as qldpc``, ``biregular_hgp(12, 3, 4, seed=42)``
     (225, 9), a circuit-noise storage simulation, and ``from
     exp_ldpc_tpu_torch.misc import run_simulation`` at 4,096 samples
     (``bposd``): failures and launches printed, K3 launched;
 37. the decoder selection (``decoders/select.py``) against every
     candidate it chooses among, at one shape per selection point and
     regime (``experiments/bench_select.py``'s cases, cut: the ``bposd``
     device step and host redecode at HGP-225 x 4, the two-tier regime, the
     single-shot host redecode and a converging batch on (H|I),
     ``bench_bp``'s fixed call, a converging QC-LP batch, flat BP at
     n = 40,000, the 1- and
     4-round detector models, the cyclic code's flat fixed call, where K6
     streams): each candidate timed on the same syndromes,
     the table printed with the card's name and power limit, and the
     automatic choice within 10% of the fastest candidate of the caller's
     request (fixed iterations, or an exit); the rule's shared memory per
     block must be the card's;
 38. the streamed routes of K2 and K6 (each phase of an iteration one grid
     over (row, shot vector) items, the messages in device memory): K2 at
     the cyclic lifted product n = 4,862 x 4 rounds (2,048, 685, 77 and 1
     shots), K6 at the n = 40,000 HGP (685, 77, 1), both at the dense HGP's
     route "wide" (77), min-sum and sum-product, against their plain
     versions (as phase 3); K2 at the cyclic code, 2,048 x 48, and K6 at
     n = 40,000, 685 x 48, timed beside the rows of
     ``artifacts/select_h100.jsonl`` that timed the same shapes before the
     redesign, the on-chip bound and the device-memory bound (every
     iteration reads and writes each f32 message once); then the slice's
     path: the ``bposd_hybrid`` ``p_sweep`` point on the cyclic code x 4
     (2,048 shots, p = 1e-4, min-sum 48 iterations, OSD-0: K2 streamed in
     the spacetime stage, K6 in the final round), its routes and shots/s,
     and the ``bposd_single_shot`` device step at HGP n = 15,625 (two
     batches of 2,048 x 48: every (H|I) round on K6 streamed).

Each run of the main path (phases 6, 7, the two runs of phase 11, phases
15, 16 and 20, each run of phase 23, the four runs of phase 24's second
part, the two runs of phase 25, the three runs of phase 28 and the runs of
phases 29-36, the two of phase 38) is driven with every launch count
set to 0 just before it and read just after (phase 16 reads the counts of
its two ranks); a kernel of that run that was not launched fails the
script.  A count is one call of
a kernel's C entry point: for K1, K3 and K5 one whole decode (up to three
grids per iteration, all enqueued by the one call: a single-shot batch is 5
K1 calls, a hybrid batch 1), for K2 and K6 one decode (resident: one grid;
streamed: two grids an iteration and a parity grid), for K4
one iteration of one shard (two grids).  The line before the
last is the kernel summary JSON (``launches`` summed over those runs,
``launches_by_run`` split by run, ``routes`` split by route: K2 and K6
"resident" / "streamed" / "resident_wide" / "streamed_wide", K1 "grids" /
"coop" / "wide", K3, K4 and K5 "default" (K5 "grids") / "wide";
``ms_wide_<shape>``, ``plain_ms_wide_<shape>``, ``bound_ms_wide_<shape>``
and ``shape_wide_<shape>`` for phase 24's shapes, ``max_abs_err_wide``;
K2's and K6's ``ms_spacetime`` / ``plain_ms_spacetime`` / ``bound_ms_spacetime``
(phase 33's shapes); K3's bounds at 685 shots and with the exit armed, K4's
at the cyclic code's D = 1, 2, 4;
K3's two-tier device steps with their bounds (phase 25), and the LER
chain's decode (``ms_stbsr_ler``, its plain time and bound, phase 35);
``routes_parity_phase``, K2's and K6's routes in their parity phase;
``ms_streamed``, their streamed route at the main shape, ``bound_dm_ms_*`` the device-memory
bound of each streamed shape (``utils/bounds.py::streamed_bound``), phase 38's
``ms_streamed_*`` and ``plain_ms_streamed_*`` with both bounds; K3b's row counts phase 17's K3 decodes,
since no main-path run reaches its sizes; without ``--quick`` only, as are
the times, ``bound_ms``, ``bound_by`` and ``library_ms``: a BP decode is
no single PyTorch call, so that is null); the last line is ``{"ok": true, "device": {...}}``.  Phase
times are printed.  It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import atexit
import csv
import json
import logging
import multiprocessing
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# Everything is read from the checkout this script stands in (never from an
# installed copy): without the port and the artifacts beside it, the script
# refuses to run.
if not all((ROOT / d).is_dir() for d in ("exp_ldpc_tpu_torch", "artifacts")):
    sys.exit(f"chip_smoke.py must run from the root of a checkout of the repository ({ROOT})")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from exp_ldpc_tpu_torch.circuits.noise import (circuit_noise, depolarizing_noise,  # noqa: E402
                                               trivial_noise)
from exp_ldpc_tpu_torch.circuits.storage_sim import build_storage_simulation  # noqa: E402
from exp_ldpc_tpu_torch.codes.bivariate_bicycle import gross_code  # noqa: E402
from exp_ldpc_tpu_torch.codes.hgp import biregular_hgp  # noqa: E402
from exp_ldpc_tpu_torch.codes.io import read_quantum_code  # noqa: E402
from exp_ldpc_tpu_torch.core import QuantumCode, QuantumCodeLogicals  # noqa: E402
from exp_ldpc_tpu_torch.utils.gf2 import rank as gf2_rank  # noqa: E402
from exp_ldpc_tpu_torch.codes.lifted import lifted_product_code_cyclic  # noqa: E402
from exp_ldpc_tpu_torch.decoders.dem import detector_error_model  # noqa: E402
from exp_ldpc_tpu_torch.decoders.spacetime import (DetectorSpacetimeCode, SpacetimeCode,  # noqa: E402
                                                   SpacetimeCodeSingleShot)
from exp_ldpc_tpu_torch.decoders import select  # noqa: E402
from exp_ldpc_tpu_torch.decoders.select import (flat_choice,  # noqa: E402
                                                spacetime_choice)
from exp_ldpc_tpu_torch.decoders.sliding_window import window_check_matrix  # noqa: E402
from exp_ldpc_tpu_torch.decoders.tanner import TannerELL  # noqa: E402
from exp_ldpc_tpu_torch.sampler.reference import FrameSampler  # noqa: E402
from exp_ldpc_tpu_torch.convert import tanner_tables  # noqa: E402
from exp_ldpc_tpu_torch.decoders import bp_bsr as k1  # noqa: E402
from exp_ldpc_tpu_torch.decoders import bp_bsr_shard as k4  # noqa: E402
from exp_ldpc_tpu_torch.decoders import bp_bsr_spacetime as k3  # noqa: E402
from exp_ldpc_tpu_torch.decoders import bp_cuda as k6  # noqa: E402
from exp_ldpc_tpu_torch.decoders import spacetime_bp_cuda as k2  # noqa: E402
from exp_ldpc_tpu_torch.decoders.bp import bp_core, priors_to_llr  # noqa: E402
from exp_ldpc_tpu_torch.decoders.bp_int8 import (int8_bp_core, int8_bp_oracle,  # noqa: E402
                                                 quantize_priors)
from exp_ldpc_tpu_torch.decoders.spacetime_bp import stbp_core  # noqa: E402
from exp_ldpc_tpu_torch.experiments import (bench_bsr_shard, bench_large_codes,  # noqa: E402
                                            shard_capacity)
from exp_ldpc_tpu_torch.native import get_gf2_lib  # noqa: E402
from exp_ldpc_tpu_torch.experiments.p_sweep import p_sweep  # noqa: E402
from exp_ldpc_tpu_torch.parallel.mesh import make_mesh, run_world  # noqa: E402
from exp_ldpc_tpu_torch.parallel.pipeline import StorageDecodePipeline  # noqa: E402
from exp_ldpc_tpu_torch.sampler.device import DeviceSampler  # noqa: E402
from exp_ldpc_tpu_torch.utils.bounds import (OPS_FLOAT, OPS_INT8, bound,  # noqa: E402
                                             streamed_bound)
from exp_ldpc_tpu_torch.utils.bounds import flat_io as _flat_io  # noqa: E402
from exp_ldpc_tpu_torch.utils.bounds import st_io as _st_io  # noqa: E402

ARTIFACT = ROOT / "artifacts" / "ler_hgp225_bposd_v5e.jsonl"
MODES_ARTIFACT = ROOT / "artifacts" / "pipeline_modes_hgp225_v5e.csv"
FAMILIES_ARTIFACT = ROOT / "artifacts" / "bp_families_v5e.jsonl"
CODE_FILE = ROOT / "artifacts" / "hgp225.qecc"
# The p = 0.006 anchor of the three pipeline modes (phases 6 and 11), made
# by the JAX package on a CPU (artifacts/make_pipeline_modes_jax_cpu.py),
# its rows with the host redecode at fixed iterations.  The selection runs
# that redecode on K3 and K1 with their exits armed; an exit shared by a
# block (K1) or the batch (K3) of the shots the device step left unconverged
# does not fire there (artifacts/select_h100.jsonl: 48 of 48 iterations in
# the rows hgp225_hard and hgp225_HI_hard), so the fixed rows are the
# contract it runs.  MODES_ARTIFACT's p = 0.006 rows, taken while the host
# redecode ran f32 per-shot-freezing BP (~10% more failures in the hybrid
# mode there), are not read.
JAX_MODES_ARTIFACT = ROOT / "artifacts" / "pipeline_modes_jax_cpu.jsonl"
P_MODES = (0.002, 0.006)
P_GATE = 0.006
ROUNDS = 4
MAX_ITER = 48
ALPHA = 0.625
OPTIONS = dict(max_iter=MAX_ITER, bp_method="ms", ms_scaling_factor=ALPHA,
               osd_method="osd_cs", osd_order=7)
METHODS = (("ms", ALPHA), ("ms", 0.0), ("ps", 0.0))
P_LO, P_HI = 0.0015157165665103977, 0.0034822022531844966
# ~ the BP-unconverged shots per 16,384-shot batch at P_HI: the ragged size
# at which the host BP+OSD redecode runs (K3 with its exit armed)
S_REDECODE = 685


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)
    log(f"  ok: {what}")


class Checks:
    """A check matrix, sparse on the host and on the card (the spacetime
    matrices of the large codes are too large to densify): i.i.d.-error
    syndromes, syndrome checks and flat priors."""

    def __init__(self, H, dev: torch.device, name: str = ""):
        self.dev = dev
        self.H = H.tocsr().astype(np.int64)
        self.name = name
        self.Hs = torch.sparse_csr_tensor(
            torch.as_tensor(self.H.indptr, dtype=torch.int64),
            torch.as_tensor(self.H.indices, dtype=torch.int64),
            torch.ones(self.H.nnz, dtype=torch.float32), self.H.shape).to(dev)

    def syndromes(self, S: int, p: float, seed: int) -> torch.Tensor:
        """(rows, S) uint8 syndromes of i.i.d. errors at rate p."""
        rng = np.random.default_rng(seed)
        err = (rng.random((S, self.H.shape[1])) < p).astype(np.int64)
        return torch.as_tensor(((self.H @ err.T) % 2).astype(np.uint8)).to(self.dev)

    def device_syndromes(self, S: int, p: float, seed: int) -> torch.Tensor:
        """(rows, S) uint8 syndromes of i.i.d. errors drawn on the device (the
        timing batches of the larger matrices: the host draw takes seconds)."""
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(seed)
        err = (torch.rand((self.H.shape[1], S), generator=gen, device=self.dev) < p)
        return torch.remainder(self.Hs @ err.to(torch.float32), 2.0).to(torch.uint8)

    def valid(self, hard: torch.Tensor, synd: torch.Tensor) -> torch.Tensor:
        par = torch.remainder(self.Hs @ hard.to(torch.float32), 2.0)
        return (par == synd.to(torch.float32)).all(dim=0)

    def prior(self, p: float) -> torch.Tensor:
        return torch.as_tensor(priors_to_llr(np.full(self.H.shape[1], p))).to(self.dev)


class Setup(Checks):
    """HGP-225 Z sector, 4 rounds: tables, priors and the spacetime matrix."""

    def __init__(self, dev: torch.device):
        self.code = biregular_hgp(12, 3, 4, seed=0, compute_logicals=True)
        H = self.code.checks.z
        self.tables = tanner_tables(TannerELL.from_check_matrix(H), dev)
        super().__init__(SpacetimeCode(H, ROUNDS).spacetime_check_matrix, dev)

    def prior(self, p: float) -> torch.Tensor:
        return super().prior(2 / 3 * p)


def phase_card() -> str:
    log("== phase 1: versions and card")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke.py runs on a GPU only")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(smi.splitlines()[0])
    check(get_gf2_lib() is not None,
          "the port's C++ GF(2)/OSD library built and loaded (the host OSD is not numpy's)")
    return smi.splitlines()[0]


KERNELS = {"K1": k1.KERNEL, "K2": k2.KERNEL, "K3": k3.KERNEL, "K4": k4.KERNEL,
           "K5": k1.KERNEL_INT8, "K6": k6.KERNEL}


def phase_build() -> None:
    log("== phase 2: build kernels (one nvcc per source, all at once)")
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(lambda kern: kern.build(), KERNELS.values()))
    for kern in KERNELS.values():
        log(f"built {kern.source.name} in {kern.build_seconds:.1f} s")
        entry = ""
        for line in kern.build_log.splitlines():
            if "Compiling entry function" in line:   # the (mangled) template instance
                entry = line.split("'")[1]
            if "registers" in line or "spill" in line:
                log(f"  {entry}: " + line.strip().replace("ptxas info    : ", ""))


def _same(tag: str, su, synd, kern, plain) -> float:
    """Kernel outputs ``kern`` against plain outputs ``plain``, both
    (hard, posterior, conv, iters).  The kernels round where their plain
    versions do (``--fmad=false``, the same left-to-right sums, bf16 at the
    same points), so hard decisions, conv and iters must be equal and
    posteriors equal to 1e-6*max(1,|x|).  Those bounds contain the stated
    ones (K2: posterior 1e-3*max(1,|x|), hard and conv agreement >= 99.9%;
    K3: hard >= 99.9%, conv >= 99%); the agreement shares are printed."""
    hk, pk, ck, ik = kern
    hp, pp, cp, ip = plain
    err = (pk - pp).abs()
    worst = float(err.max())
    log(f"  {tag}: max|dpost| {worst:.3g}, hard agree {float((hk == hp).float().mean()):.6f}, "
        f"conv agree {float((ck == cp).float().mean()):.6f}, conv rate "
        f"{float(cp.float().mean()):.4f}, iters {int(ik.max())}/{int(ip.max())}")
    check(bool((err <= 1e-6 * pp.abs().clamp(min=1.0)).all()),
          f"{tag}: posterior within 1e-6*max(1,|x|) of plain")
    check(torch.equal(hk, hp), f"{tag}: hard decisions equal to plain")
    check(torch.equal(ck, cp), f"{tag}: conv equal to plain")
    check(torch.equal(ik, ip), f"{tag}: iters equal to plain")
    check(bool(su.valid(hk, synd)[ck].all()), f"{tag}: every conv=1 shot satisfies its syndrome")
    return worst


def _plan_tag(plan) -> str:
    if plan.route == "streamed":   # the device-memory grids: lane width and blocks of each
        return (f"{plan.label} shots={plan.shots} (live {plan.live}) " + " ".join(
            f"{k}=vec {g.vec} x {g.blocks} blocks" for k, g in
            (("checks", plan.checks), ("variables", plan.variables), ("parity", plan.parity))))
    return (f"{plan.label} G={plan.group} stride={plan.stride} blocks={plan.blocks} "
            f"threads={plan.threads} tables_smem={plan.tables_smem} smem={plan.smem_bytes} B")


def _routes_since(kern, before: dict) -> dict:
    return {r: n - before.get(r, 0) for r, n in kern.routes.items() if n != before.get(r, 0)}


# Shot counts added to the K2 and K6 parity phases: below the SM count (one
# shot per block), and ragged past one wave (the last block holds fewer
# shots than the others).
S_SMALL, S_RAGGED = 77, 5001


def _gross(dev: torch.device):
    """The gross code [[144,12,12]]'s Z checks over 12 rounds (the reference's
    bench_gross configuration): tables and the spacetime matrix."""
    H = gross_code().checks.z
    return (tanner_tables(TannerELL.from_check_matrix(H), dev),
            Checks(SpacetimeCode(H, GROSS_ROUNDS).spacetime_check_matrix, dev,
                   f"gross x{GROSS_ROUNDS} rounds"))


GROSS_ROUNDS, GROSS_ITERS = 12, 60


def phase_k2(su: Setup, sizes, dev: torch.device):
    """Returns the worst posterior error and the routes this phase ran."""
    log(f"== phase 3: K2 vs plain, S in {sizes + (S_SMALL, S_RAGGED)}, {MAX_ITER} iterations; "
        f"the gross code x{GROSS_ROUNDS} rounds; the streamed route")
    p = 3e-3
    prior = su.prior(p)
    worst = 0.0
    before = dict(k2.KERNEL.routes)

    def case(tag, chk, tables, rounds, prior, synd, method, msf, iters, route="auto"):
        plan = k2.launch_plan(tables, rounds, synd.shape[1], dev, route=route)
        kern = k2.stbp_fixed(tables, rounds, prior, synd, method, iters, msf, plan=plan)
        plain = stbp_core(tables, rounds, prior, synd, method, iters, msf, early_stop=False)
        torch.cuda.synchronize()
        return _same(f"{tag} {method} alpha={msf} [{_plan_tag(plan)}]", chk, synd, kern, plain)

    for S in sizes + (S_SMALL, S_RAGGED):
        synd = su.syndromes(S, p, seed=1)
        for method, msf in METHODS:
            worst = max(worst, case(f"S={S}", su, su.tables, ROUNDS, prior, synd, method, msf,
                                    MAX_ITER))
    plan = k2.launch_plan(su.tables, ROUNDS, S_RAGGED, dev)
    check(plan.route == "resident" and S_RAGGED % plan.group != 0,
          f"S={S_RAGGED}: ragged ({S_RAGGED} = {S_RAGGED // plan.group} x {plan.group} + "
          f"{S_RAGGED % plan.group})")
    check(k2.launch_plan(su.tables, ROUNDS, S_SMALL, dev).blocks == S_SMALL,
          f"S={S_SMALL}: one shot per block, {S_SMALL} blocks")
    # the streamed route (the device-memory grids) at a main-path size
    synd = su.syndromes(sizes[0], p, seed=1)
    worst = max(worst, case(f"S={sizes[0]} streamed", su, su.tables, ROUNDS, prior, synd, "ms",
                            ALPHA, MAX_ITER, route="streamed"))
    # the gross code over 12 rounds: Dc 6, the exact 8-slot instance
    tables, gst = _gross(dev)
    synd = gst.syndromes(sizes[1], p, seed=15)
    for method, msf in METHODS:
        worst = max(worst, case(f"{gst.name} S={sizes[1]}", gst, tables, GROSS_ROUNDS,
                                gst.prior(2 / 3 * p), synd, method, msf, GROSS_ITERS))
    # over the budget: one shot's state exceeds the opt-in shared memory
    H = biregular_hgp(80, 3, 4, seed=7, compute_logicals=False).checks.z
    tables = tanner_tables(TannerELL.from_check_matrix(H), dev)
    big = Checks(SpacetimeCode(H, 8).spacetime_check_matrix, dev, "HGP n=10000 x8 rounds")
    synd = big.syndromes(128, 1e-3, seed=16)
    check(k2.launch_plan(tables, 8, 128, dev).route == "streamed",
          f"{big.name}: {k2.resident_bytes(tables, 8)[0]} B per shot takes the streamed route")
    for method, msf in (("ms", ALPHA), ("ps", 0.0)):
        worst = max(worst, case(f"{big.name} S=128", big, tables, 8, big.prior(1e-3), synd,
                                method, msf, 4))
    routes = _routes_since(k2.KERNEL, before)
    check(routes.get("resident", 0) > 0 and routes.get("streamed", 0) > 0,
          f"K2 ran both routes: {routes}")
    return worst, routes


def phase_k3(su: Setup, sizes, ragged) -> float:
    log(f"== phase 4: K3 vs plain (bf16 messages), S in {sizes}, {MAX_ITER} iterations")
    p = 3e-3
    prior = su.prior(p)
    worst = 0.0
    cases = (("ms", ALPHA, False), ("ms", 0.0, False), ("ps", 0.0, False), ("ms", ALPHA, True))
    plain = k3._stbsr_iter_plain
    for S in sizes:
        synd = su.syndromes(S, p, seed=2)
        for method, msf, es in cases:
            kern = k3.stbsr_decode(su.tables, ROUNDS, prior, synd, method, MAX_ITER, msf, es)
            ref = k3.stbsr_decode(su.tables, ROUNDS, prior, synd, method, MAX_ITER, msf, es,
                                  iterate=plain)
            torch.cuda.synchronize()
            worst = max(worst, _same(f"S={S} {method} alpha={msf} early_stop={es}", su, synd,
                                     kern, ref))
    # the exit on the device: a hard batch never fires it, an easy one does
    S = sizes[-1] // 4
    for p_err, fires in ((p, False), (2e-4, True)):
        synd = su.syndromes(S, p_err, seed=12)
        before = k3.KERNEL.launches
        kern = k3.stbsr_decode(su.tables, ROUNDS, prior, synd, "ms", MAX_ITER, ALPHA, True)
        check(k3.KERNEL.launches == before + 1, "one call of K3's entry point per decode")
        ref = k3.stbsr_decode(su.tables, ROUNDS, prior, synd, "ms", MAX_ITER, ALPHA, True,
                              iterate=plain)
        worst = max(worst, _same(f"S={S} p={p_err} early exit", su, synd, kern, ref))
        it = int(kern[3][0])
        check((it < MAX_ITER) == fires and bool(kern[2].all()) == fires,
              f"p={p_err}: the exit {'fires' if fires else 'never fires'} ({it} of {MAX_ITER} "
              "iterations, as the plain loop)")
    # single iterations of the kernels on ragged tensors (one shot per thread)
    for S in ragged:
        synd = su.syndromes(S, p, seed=13)
        for method, msf, es in (("ms", ALPHA, True), ("ps", 0.0, False)):
            kern = k3.stbsr_decode(su.tables, ROUNDS, prior, synd, method, 12, msf, es,
                                   iterate=k3.stbsr_iter)
            ref = k3.stbsr_decode(su.tables, ROUNDS, prior, synd, method, 12, msf, es,
                                  iterate=plain)
            torch.cuda.synchronize()
            worst = max(worst, _same(f"S={S} {method} early_stop={es}, one iteration per call",
                                     su, synd, kern, ref))
    return worst


SAMPLER_P = 3e-3


def _noisy(su: Setup):
    return build_storage_simulation(
        ROUNDS, depolarizing_noise(SAMPLER_P, SAMPLER_P), su.code)


def host_rates(su: Setup, shots: int) -> np.ndarray:
    """Detector rates of the host oracle ``FrameSampler`` (~10 s of host work
    at 16,384 shots, drawn in a thread beside phases 2-4)."""
    return FrameSampler(_noisy(su).circuit, seed=7).sample_detectors(shots).mean(axis=0)


def phase_sampler(su: Setup, dev: torch.device, n_dev: int, n_host: int, host) -> None:
    log("== phase 5: device sampler")
    quiet = build_storage_simulation(ROUNDS, trivial_noise(), su.code)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    det = DeviceSampler(quiet.circuit, 4096, dev).sample_detectors(gen, append_observables=True)
    check(int(det.sum()) == 0, "noiseless circuit: all detectors and observables are 0")
    ds = DeviceSampler(_noisy(su).circuit, n_dev, dev)
    rate_dev = ds.sample_detectors(gen).to(torch.float64).mean(dim=0).cpu().numpy()
    rate_host = host.result()
    pooled = (rate_dev * n_dev + rate_host * n_host) / (n_dev + n_host)
    sigma = np.sqrt(pooled * (1 - pooled) * (1 / n_dev + 1 / n_host))
    z = np.abs(rate_dev - rate_host) / np.where(sigma > 0, sigma, 1.0)
    log(f"  {rate_dev.size} detectors, mean rate device {rate_dev.mean():.5f} host "
        f"{rate_host.mean():.5f}, max |z| {z.max():.2f}")
    check(bool((z <= 5.0).all()), "every detector rate within 5 sigma of FrameSampler")


def artifact_point(p: float) -> dict:
    for line in ARTIFACT.read_text().splitlines():
        rec = json.loads(line)
        if "p_ph" in rec and abs(rec["p_ph"] - p) < 1e-15:
            return rec
    raise KeyError(p)


def _ler_gap(failures: int, samples: int, ler_ref: float, samples_ref: int, label: str,
             k: float = 4.0) -> bool:
    """LER within ``k`` combined binomial sigma of a reference point."""
    l1, n1 = failures / samples, samples
    l2, n2 = ler_ref, samples_ref
    sigma = np.sqrt(l1 * (1 - l1) / n1 + l2 * (1 - l2) / n2)
    log(f"  {label}: LER {l1:.5f} ({failures}/{samples}) vs artifact {l2:.5f}, "
        f"|diff| = {abs(l1 - l2) / sigma:.2f} sigma")
    return abs(l1 - l2) <= k * sigma


def ler_within(failures: int, samples: int, p: float, k: float = 4.0) -> bool:
    art = artifact_point(p)
    return _ler_gap(failures, samples, art["ler"], art["samples"], f"p={p:.6g}", k)


def jax_modes_anchor(mode: str, p: float) -> tuple:
    """(LER, samples, source) of ``mode`` at ``p`` in :data:`JAX_MODES_ARTIFACT`,
    the row whose host redecode runs at fixed iterations (f32): the
    contract the armed K3 and K1 run on those shots, whose shared exit does
    not fire there."""
    for line in JAX_MODES_ARTIFACT.read_text().splitlines():
        rec = json.loads(line)
        if rec["mode"] == mode and abs(rec["p"] - p) <= 1e-12 and rec["redecode"] == "fixed":
            return rec["failures"] / rec["samples"], rec["samples"], JAX_MODES_ARTIFACT.name
    raise KeyError((mode, p))


def mode_anchor(mode: str, p: float) -> tuple:
    """(LER, samples, source) a pipeline mode's point is gated on: the bposd
    artifact (``bposd`` at its grid points), ``pipeline_modes_hgp225_v5e.csv``
    (the single-shot and hybrid modes at p = 0.002), the JAX package's CPU
    rows at p = 0.006."""
    if abs(p - P_GATE) <= 1e-12:
        return jax_modes_anchor(mode, p)
    if mode == "bposd":
        art = artifact_point(p)
        return art["ler"], art["samples"], ARTIFACT.name
    art = modes_artifact(mode, p)
    return int(art["failures"]) / int(art["samples"]), int(art["samples"]), MODES_ARTIFACT.name


def modes_artifact(mode: str, p: float) -> dict:
    """The row of ``pipeline_modes_hgp225_v5e.csv`` for ``mode`` at ``p``."""
    rows = [ln for ln in MODES_ARTIFACT.read_text().splitlines() if not ln.startswith("#")]
    for rec in csv.DictReader(rows):
        if rec["decoder_mode"] == mode and abs(float(rec["p_ph"]) - p) < 1e-12:
            return rec
    raise KeyError((mode, p))


class _PointLog(logging.Handler):
    """Collects the per-point log records of p_sweep (p, failures, shots, OSD-decoded, s)."""

    def __init__(self):
        super().__init__()
        self.points = []

    def emit(self, record):
        self.points.append(record.args)


def phase_main_path(su: Setup, dev: torch.device, samples: int, shots: int) -> dict:
    log(f"== phase 6: main path p_sweep, {samples} shots per point, batch {shots}")
    handler = _PointLog()
    lg = logging.getLogger("exp_ldpc_tpu_torch.p_sweep")
    lg.addHandler(handler)
    lg.setLevel(logging.INFO)
    reset_counts()
    records = p_sweep(
        samples=samples, p_values=np.array([P_LO, P_HI, P_GATE]),
        noise_model=depolarizing_noise,
        noise_model_args=lambda p: {"p": p, "pm": p},
        meas_prior=lambda p, xs, zs: 2 / 3 * p, data_prior=lambda p, xs, zs: 2 / 3 * p,
        seed=0, pipeline={"mesh_devices": 1, "shots_per_device": shots}, device=dev,
        code=su.code, rounds=ROUNDS, decoder_mode="bposd", bp_osd_options=dict(OPTIONS))
    torch.cuda.synchronize()
    launches = launch_counts()
    lg.removeHandler(handler)
    log(f"  kernel launches during the sweep: {launches}")
    for (p, f, n, osd, secs) in handler.points:
        log(f"  p={p:.6g}: failures {f}, shots {n}, OSD-decoded {osd}, "
            f"{n / secs:.0f} decoded shots/s ({secs:.2f} s)")
    for rec in records:
        ler, n_ref, src = mode_anchor("bposd", rec["p_ph"])
        check(_ler_gap(rec["failures"], rec["samples"], ler, n_ref, f"p={rec['p_ph']:.6g}"),
              f"p={rec['p_ph']:.6g}: LER within 4 sigma of {src}")
    check(spacetime_choice(su.tables, ROUNDS, dev, early_stop=False) == "K2"
          and launches["K2"] > 0 and launches["K3"] > 0,
          "the selection's kernels at HGP-225 x4 launched on the main path: K2 in the device "
          "step (fixed iterations), K3 with its exit in the host redecode (early stop)")
    return launches


def phase_k3_pipeline(su: Setup, dev: torch.device, shots: int) -> dict:
    log(f"== phase 7: pipeline on K3 (bp_backend='stbsr'), {shots} shots at p={P_HI:.6g}")
    p = P_HI
    pipe = StorageDecodePipeline(
        code=su.code, rounds=ROUNDS, noise_model=depolarizing_noise(p, p),
        data_prior=2 / 3 * p, meas_prior=2 / 3 * p, shots_per_device=shots,
        max_iter=MAX_ITER, bp_method="ms", ms_scaling_factor=ALPHA, bp_backend="stbsr",
        osd_fallback_cap=shots, osd_options=dict(OPTIONS), device=dev)
    check(pipe.kernel == "stbsr", "pipeline resolved to K3")
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    reset_counts()
    f, n, osd = pipe.run_bposd(gen)
    torch.cuda.synchronize()
    launches = launch_counts()
    log(f"  failures {f}, shots {n}, OSD-decoded {osd}, kernel launches {launches}")
    check(launches["K3"] > 0, "K3 launched on the pipeline")
    check(ler_within(f, n, p), "K3 pipeline LER within 4 sigma of the artifact")
    return launches


# each kernel's launches on the main path by route (K2, K6: resident /
# streamed; the others one route, "default"), summed over its runs
MAIN_ROUTES = {name: {} for name in KERNELS}


def launch_counts() -> dict:
    """The launches since the last reset; also adds their routes to
    ``MAIN_ROUTES`` (every caller reads a run of the main path)."""
    for name, kern in KERNELS.items():
        for route, n in kern.routes.items():
            MAIN_ROUTES[name][route] = MAIN_ROUTES[name].get(route, 0) + n
    return {name: kern.launches for name, kern in KERNELS.items()}


def reset_counts() -> None:
    for kern in KERNELS.values():
        kern.reset_counts()


def _timed(fn):
    """(fn(), its time in ms by CUDA events)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _median_ms(fn, inputs) -> float:
    return float(np.median([_timed(lambda: fn(x))[1] for x in inputs]))


def phase_timings(su: Setup, dev: torch.device, shots: int) -> dict:
    log(f"== phase 8: timings, S={shots}, {MAX_ITER} iterations, median of 5")
    p = P_HI
    prior = su.prior(p)
    synds = [su.syndromes(shots, p, seed=100 + i) for i in range(6)]
    args = (su.tables, ROUNDS, prior)
    warm = synds[5]
    t = {}
    k2.stbp_fixed(*args, warm, "ms", MAX_ITER, ALPHA)
    stbp_core(*args, warm, "ms", MAX_ITER, ALPHA, early_stop=False)
    t["K2"] = _median_ms(lambda s: k2.stbp_fixed(*args, s, "ms", MAX_ITER, ALPHA), synds[:5])
    t["K2_plain"] = _median_ms(
        lambda s: stbp_core(*args, s, "ms", MAX_ITER, ALPHA, early_stop=False), synds[:5])
    # the streamed route (the device-memory grids) on the same inputs
    streamed = k2.launch_plan(su.tables, ROUNDS, shots, dev, route="streamed")
    k2.stbp_fixed(*args, warm, "ms", MAX_ITER, ALPHA, plan=streamed)
    t["K2_streamed"] = _median_ms(
        lambda s: k2.stbp_fixed(*args, s, "ms", MAX_ITER, ALPHA, plan=streamed), synds[:5])
    small2 = [x[:, :S_REDECODE].contiguous() for x in synds]
    t[f"K2_S{S_REDECODE}"] = _median_ms(
        lambda s: k2.stbp_fixed(*args, s, "ms", MAX_ITER, ALPHA), small2[:5])
    t[f"K2_S{S_REDECODE}_plain"] = _median_ms(
        lambda s: stbp_core(*args, s, "ms", MAX_ITER, ALPHA, early_stop=False), small2[:5])
    # the gross code over 12 rounds, 60 iterations (bench_gross's decoder)
    gtab, gst = _gross(dev)
    gprior = gst.prior(2 / 3 * p)
    gsyn = [gst.device_syndromes(shots, p, seed=150 + i) for i in range(4)]
    gargs = (gtab, GROSS_ROUNDS, gprior)
    k2.stbp_fixed(*gargs, gsyn[3], "ms", GROSS_ITERS, ALPHA)
    t["K2_gross"] = _median_ms(lambda s: k2.stbp_fixed(*gargs, s, "ms", GROSS_ITERS, ALPHA),
                               gsyn[:3])
    t["K2_gross_plain"] = _median_ms(
        lambda s: stbp_core(*gargs, s, "ms", GROSS_ITERS, ALPHA, early_stop=False), gsyn[:2])
    for tag, plan in ((f"HGP-225 S={shots}", k2.launch_plan(su.tables, ROUNDS, shots, dev)),
                      (f"HGP-225 S={S_REDECODE}",
                       k2.launch_plan(su.tables, ROUNDS, S_REDECODE, dev)),
                      (f"gross x{GROSS_ROUNDS} S={shots}",
                       k2.launch_plan(gtab, GROSS_ROUNDS, shots, dev))):
        log(f"  K2 plan at {tag}: {_plan_tag(plan)}")
    k3.stbsr_decode(*args, warm, "ms", MAX_ITER, ALPHA, False)
    t["K3"] = _median_ms(lambda s: k3.stbsr_decode(*args, s, "ms", MAX_ITER, ALPHA, False),
                         synds[:5])
    plain = k3._stbsr_iter_plain
    k3.stbsr_decode(*args, warm, "ms", MAX_ITER, ALPHA, False, iterate=plain)
    t["K3_plain"] = _median_ms(
        lambda s: k3.stbsr_decode(*args, s, "ms", MAX_ITER, ALPHA, False, iterate=plain),
        synds[:5])
    # the flag traffic of the early exit (which never fires at this p)
    t["K3_es"] = _median_ms(lambda s: k3.stbsr_decode(*args, s, "ms", MAX_ITER, ALPHA, True),
                            synds[:5])
    # K3 at the ragged size of the host BP+OSD redecode
    small = [x[:, :S_REDECODE].contiguous() for x in synds]
    t[f"K3_S{S_REDECODE}"] = _median_ms(
        lambda s: k3.stbsr_decode(*args, s, "ms", MAX_ITER, ALPHA, False), small[:5])
    t[f"K3_S{S_REDECODE}_es"] = _median_ms(
        lambda s: k3.stbsr_decode(*args, s, "ms", MAX_ITER, ALPHA, True), small[:5])
    t[f"K3_S{S_REDECODE}_plain"] = _median_ms(
        lambda s: k3.stbsr_decode(*args, s, "ms", MAX_ITER, ALPHA, False, iterate=plain),
        small[:5])
    # the plain version with the exit armed (its loop tests the exit every iteration)
    t["K3_es_plain"] = _median_ms(
        lambda s: k3.stbsr_decode(*args, s, "ms", MAX_ITER, ALPHA, True, iterate=plain),
        synds[:5])
    t[f"K3_S{S_REDECODE}_es_plain"] = _median_ms(
        lambda s: k3.stbsr_decode(*args, s, "ms", MAX_ITER, ALPHA, True, iterate=plain),
        small[:5])
    # the shot-iterations those armed-exit batches need (their bound's work)
    for tag, batch in (("es", synds), (f"S{S_REDECODE}_es", small)):
        t[f"K3_{tag}_shot_iters"] = float(np.mean([
            int(k3.stbsr_decode(*args, x, "ms", MAX_ITER, ALPHA, True)[3].sum())
            for x in batch[:5]]))
    sim = build_storage_simulation(ROUNDS, depolarizing_noise(p, p), su.code)
    ds = DeviceSampler(sim.circuit, shots, dev)
    gens = []
    for i in range(6):
        g = torch.Generator(device=dev)
        g.manual_seed(200 + i)
        gens.append(g)
    ds.sample(gens[5])
    t["sampler"] = _median_ms(ds.sample, gens[:5])
    # the automatic choice (K2 in the device step, K3 armed in the host redecode)
    # and the JAX package's TPU choice (bp_backend "stbsr": K3 in both), in turns
    pipes = {f"_{backend}" if backend == "stbsr" else "": StorageDecodePipeline(
        code=su.code, rounds=ROUNDS, noise_model=depolarizing_noise(p, p),
        data_prior=2 / 3 * p, meas_prior=2 / 3 * p, shots_per_device=shots,
        max_iter=MAX_ITER, bp_method="ms", ms_scaling_factor=ALPHA, bp_backend=backend,
        osd_fallback_cap=shots, osd_options=dict(OPTIONS), device=dev)
        for backend in ("auto", "stbsr")}
    check(pipes[""].kernel == "stbp" and pipes["_stbsr"].kernel == "stbsr",
          "the automatic bposd stage is K2; bp_backend='stbsr' is K3")
    # run_bposd = sample, device decode (syndromes, BP, failure count, OSD
    # compaction), host BP+OSD of the unconverged shots; timed stage by stage
    stages = {tag: {"sample": [], "device_decode": [], "host_osd": [], "e2e": []}
              for tag in pipes}
    for pipe in pipes.values():
        pipe.run_bposd(gens[5])
    for g in gens[:5]:
        for tag, pipe in pipes.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            record = pipe._sample(g, pipe._noise_args)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = pipe._decode_records(record)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            pipe._finish_bposd(*out)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            for k, v in zip(stages[tag], (t1 - t0, t2 - t1, t3 - t2, t3 - t0)):
                stages[tag][k].append(v)
    for tag, st in stages.items():
        for k, v in st.items():
            t[f"{k}{tag}_s"] = float(np.median(v))
    for k, v in t.items():
        if not k.endswith("_shot_iters"):
            log(f"  {k}: {v:.4f}" + (" s" if k.endswith("_s") else " ms"))
    log(f"  end to end: {shots / t['e2e_s']:.0f} decoded shots/s at p={p:.6g} (K2 in the device "
        f"step; K3 there too: {shots / t['e2e_stbsr_s']:.0f})")
    return t


# ---------------------------------------------------------------------------
# The flat BP kernels K1 and K6, and the single-shot and hybrid modes
# ---------------------------------------------------------------------------

FLAT_P = 5e-3


class FlatSetup(Checks):
    """One flat check matrix on the card, with K1's layout (which holds the
    Tanner tables K6 reads too)."""

    def __init__(self, H, dev: torch.device, name: str):
        super().__init__(H, dev, name)
        self.layout = k1.BSRLayout.from_tanner(TannerELL.from_check_matrix(self.H), dev)
        self.tables = self.layout.tables


def flat_setups(su: Setup, dev: torch.device):
    """HGP-225's Z checks H (the final-round stage) and (H|I) (the
    single-shot rounds), and the >= 3,000-tile n = 40,000 HGP (K1b's regime)."""
    H = su.code.checks.z
    flats = [FlatSetup(H, dev, "H"),
             FlatSetup(SpacetimeCodeSingleShot(H).spacetime_check_matrix, dev, "(H|I)")]
    big = FlatSetup(biregular_hgp(160, 3, 4, seed=0).checks.z, dev, "HGP n=40000")
    check(big.layout.num_tiles >= 3000,
          f"{big.name}: {big.layout.num_tiles} BSR tiles (>= 3,000: the K1b regime)")
    return flats, big


def phase_k6(flats, big, sizes, dev: torch.device):
    """Returns the worst posterior error and the routes this phase ran."""
    log(f"== phase 9: K6 vs plain (f32), S in {sizes + (S_SMALL, S_RAGGED)}, {MAX_ITER} "
        "iterations; the streamed route")
    worst = 0.0
    before = dict(k6.KERNEL.routes)

    def case(tag, fs, prior, synd, method, msf, iters, route="auto"):
        plan = k6.launch_plan(fs.tables, synd.shape[1], dev, route=route)
        kern = k6.bp_fixed(fs.tables, prior, synd, method, iters, msf, plan=plan)
        plain = bp_core(fs.tables, prior, synd, method, iters, msf, early_stop=False)
        torch.cuda.synchronize()
        return _same(f"{fs.name} {tag} {method} alpha={msf} [{_plan_tag(plan)}]", fs, synd, kern,
                     plain)

    for fs in flats:
        prior = fs.prior(FLAT_P)
        for S in sizes + (S_SMALL, S_RAGGED):
            synd = fs.syndromes(S, FLAT_P, seed=3)
            for method, msf in METHODS:
                worst = max(worst, case(f"S={S}", fs, prior, synd, method, msf, MAX_ITER))
        plan = k6.launch_plan(fs.tables, S_RAGGED, dev)
        check(plan.route == "resident" and S_RAGGED % plan.group != 0,
              f"{fs.name} S={S_RAGGED}: ragged ({S_RAGGED} = {S_RAGGED // plan.group} x "
              f"{plan.group} + {S_RAGGED % plan.group})")
        synd = fs.syndromes(sizes[0], FLAT_P, seed=3)
        worst = max(worst, case(f"S={sizes[0]} streamed", fs, prior, synd, "ms", ALPHA, MAX_ITER,
                                route="streamed"))
    # over the budget: the n = 40,000 HGP (557 KB a shot)
    synd = big.syndromes(128, 2e-3, seed=17)
    check(k6.launch_plan(big.tables, 128, dev).route == "streamed",
          f"{big.name}: {k6.resident_bytes(big.tables)[0]} B per shot takes the streamed route")
    for method, msf in (("ms", ALPHA), ("ps", 0.0)):
        worst = max(worst, case("S=128", big, big.prior(2e-3), synd, method, msf, 4))
    routes = _routes_since(k6.KERNEL, before)
    check(routes.get("resident", 0) > 0 and routes.get("streamed", 0) > 0,
          f"K6 ran both routes: {routes}")
    return worst, routes


# Shot counts and shot blocks of the K1/K5 exit cases (phases 10 and 19): one
# shot, below and at one block, ragged past two (all padded to a multiple of
# 16 on the card), the host redecode's size; blocks of 128 and 256 shots
S_EXIT, SB_EXIT = (1, 77, 128, 300, 685), (128, 256)


def _mixed_syndromes(fs: Checks, S: int, seed: int) -> torch.Tensor:
    """Syndromes whose shot blocks exit at different iterations: shots
    0-127 all zero (a 128-shot block stops after one iteration), the rest
    from i.i.d. errors at p = 3e-3."""
    synd = fs.syndromes(S, 3e-3, seed)
    synd[:, :128] = 0
    return synd


def _bsr_plan_tag(fs: "FlatSetup", S: int, sb: int, int8: bool = False,
                  coop: bool = False) -> str:
    """The plan K1 (or K5) runs a decode of S shots in blocks of sb on."""
    t = fs.layout.tables
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sb, _g = k1._blocks(sb, S)
    plan = k1.bsr_plan(t.num_checks, t.num_vars, t.max_check_degree, t.max_var_degree, S, sb,
                       sms, int8, coop)
    return (f"{plan.route}: shots {plan.shots} ({plan.live} live), blocks of {plan.shot_block} x "
            f"{plan.groups}, vec/grid A {plan.checks.vec}/{plan.checks.blocks} B "
            f"{plan.variables.vec}/{plan.variables.blocks} C {plan.parity.vec}/"
            f"{plan.parity.blocks}")


def _k1_case(fs: FlatSetup, synd, prior, method, msf, early_stop, iters, sb=None) -> float:
    sb = k1.auto_shot_block(fs.layout) if sb is None else sb
    before = k1.KERNEL.launches
    kern = k1.bsr_bp_decode(fs.layout, prior, synd, method, iters, msf, early_stop, sb)
    plain = k1.bsr_bp_plain(fs.layout, prior, synd, method, iters, msf, early_stop, sb)
    torch.cuda.synchronize()
    check(k1.KERNEL.launches == before + 1, f"{fs.name}: one K1 call per decode")
    it = kern[3]
    blocks = it[::sb]
    check(torch.equal(it, blocks.repeat_interleave(sb)[: it.numel()]),
          f"{fs.name}: iters constant within each {sb}-shot block")
    tag = (f"{fs.name} S={synd.shape[1]} sb={sb} {method} alpha={msf} early_stop={early_stop} "
           f"(block iters {blocks.tolist()[:8]}) "
           f"[{_bsr_plan_tag(fs, synd.shape[1], sb, coop=k1.COOPERATIVE and method == 'ms')}]")
    check(torch.equal(kern[1], plain[1]), f"{tag}: posterior bit-identical to plain")
    return _same(tag, fs, synd, kern, plain)


def phase_k1(flats, big, cyclic, sizes, quick: bool):
    log(f"== phase 10: K1 vs plain (bf16 messages), S in {sizes}, {MAX_ITER} iterations; shot "
        f"blocks exiting apart, S in {S_EXIT}, blocks of {SB_EXIT}; the cyclic code (Dc 24)")
    worst = 0.0
    for fs in flats:
        prior = fs.prior(FLAT_P)
        for S in sizes:
            synd = fs.syndromes(S, FLAT_P, seed=4)
            for method, msf in METHODS:
                for es in (False, True):
                    worst = max(worst, _k1_case(fs, synd, prior, method, msf, es, MAX_ITER))
        for S in S_EXIT:
            synd = _mixed_syndromes(fs, S, seed=6)
            for sb in SB_EXIT:
                for method, msf, es in (("ms", ALPHA, True), ("ms", 0.0, True), ("ps", 0.0, False)):
                    worst = max(worst, _k1_case(fs, synd, prior, method, msf, es, MAX_ITER, sb))
                    if es and sb == 128 and S >= 256:
                        it = k1.bsr_bp_decode(fs.layout, prior, synd, method, MAX_ITER, msf, True,
                                              sb)[3]
                        check(int(it[0]) == 1 and int(it[128]) > 1,
                              f"{fs.name} S={S}: the all-zero block stops after 1 iteration, "
                              f"the next after {int(it[128])}")
    prior = cyclic.prior(FAM_P)
    synd = cyclic.syndromes(FAM_SHOTS, FAM_P, seed=7)
    for method, msf, es in (("ms", ALPHA, False), ("ms", 0.0, True), ("ps", 0.0, False)):
        worst = max(worst, _k1_case(cyclic, synd, prior, method, msf, es, FAM_ITERS, 128))
    S_big, it_big = (64, 4) if quick else (256, 8)
    log(f"  K1b regime: {big.name}, {big.layout.num_tiles} tiles, S={S_big}, {it_big} iterations")
    prior = big.prior(2e-3)
    synd = big.syndromes(S_big, 2e-3, seed=5)
    worst_b = 0.0
    for method, msf, es in (("ms", ALPHA, False), ("ms", ALPHA, True), ("ps", 0.0, False)):
        worst_b = max(worst_b, _k1_case(big, synd, prior, method, msf, es, it_big))
    return worst, worst_b


def phase_modes(dev: torch.device, samples: int, shots: int) -> dict:
    """Both modes through the sweep driver; returns the launches of each run."""
    with CODE_FILE.open() as f:
        code = read_quantum_code(f, validate_stabilizer_code=True)
    by_run = {}
    for mode in ("bposd_single_shot", "bposd_hybrid"):
        log(f"== phase 11: {mode} p_sweep on {CODE_FILE.name}, p in {P_MODES}, {samples} "
            f"shots per point, batch {shots}")
        handler = _PointLog()
        lg = logging.getLogger("exp_ldpc_tpu_torch.p_sweep")
        lg.addHandler(handler)
        lg.setLevel(logging.INFO)
        reset_counts()
        records = p_sweep(
            samples=samples, p_values=np.array(P_MODES),
            noise_model=depolarizing_noise, noise_model_args=lambda p: {"p": p, "pm": p},
            meas_prior=lambda p, xs, zs: 2 / 3 * p, data_prior=lambda p, xs, zs: 2 / 3 * p,
            seed=0, pipeline={"mesh_devices": 1, "shots_per_device": shots}, device=dev,
            code=code, rounds=ROUNDS, decoder_mode=mode, bp_osd_options=dict(OPTIONS))
        torch.cuda.synchronize()
        launches = launch_counts()
        lg.removeHandler(handler)
        batches = samples // shots * len(P_MODES)
        log(f"  kernel launches during the sweep: {launches}; per batch K6 (device step) "
            f"{launches['K6'] / batches:g}, K1 (host redecode) {launches['K1'] / batches:g}")
        for (p, f, n, osd, secs) in handler.points:
            log(f"  p={p:.6g}: failures {f}, shots {n}, OSD-decoded {osd}, "
                f"{n / secs:.0f} decoded shots/s ({secs:.2f} s)")
        for rec in records:
            ler, ref_n, src = mode_anchor(mode, rec["p_ph"])
            check(_ler_gap(rec["failures"], rec["samples"], ler, ref_n,
                           f"{mode} p={rec['p_ph']:.6g}"),
                  f"{mode} p={rec['p_ph']:.6g}: LER within 4 sigma of {src}")
        # fixed iterations in the device step: K6, and K2 in the hybrid spacetime
        # stage; the early exit in the host redecode: K1, and K3 in the hybrid's
        for name in ("K6", "K1") + (("K2", "K3") if mode == "bposd_hybrid" else ()):
            check(launches[name] > 0, f"{mode}: {name} launched on the main path")
        by_run[f"p_sweep_{mode}"] = launches
    return by_run


# The times of K1 and K5 before their redesign (the 32-shot-block kernels,
# one launch per iteration with the early exit; chip_smoke.py on an NVIDIA
# H100 80GB HBM3 at 700 W), printed beside this run's for comparison.
OLD_KERNEL_MS = {"K1_S16384": 4.48, "K1_S16384_es": 6.76, f"K1_S{S_REDECODE}_es": 3.54,
          "K1_bench": 1.25, "K1_n40000": 104.9, "K1_fam_cyclic": 122.0, "K5_cyclic": 106.2,
          "K5_qclp": 6.29}


def phase_flat_timings(flats, big, dev: torch.device, shots: int) -> dict:
    log("== phase 12: K1 and K6 timings (median of 5 distinct-input runs) and the modes' "
        "stages")
    t = {}
    H, Hss = flats

    def pair(tag, fs, S, iters, p, early_stop=False):
        prior = fs.prior(p)
        synds = [fs.syndromes(S, p, seed=300 + i) for i in range(6)]
        sb = k1.auto_shot_block(fs.layout)
        fns = {
            f"K1_{tag}": lambda s: k1.bsr_bp_decode(fs.layout, prior, s, "ms", iters, ALPHA,
                                                    early_stop, sb),
            f"K1_{tag}_plain": lambda s: k1.bsr_bp_plain(fs.layout, prior, s, "ms", iters,
                                                         ALPHA, early_stop, sb)}
        if not early_stop:
            fns[f"K6_{tag}"] = lambda s: k6.bp_fixed(fs.tables, prior, s, "ms", iters, ALPHA)
            fns[f"K6_{tag}_plain"] = lambda s: bp_core(fs.tables, prior, s, "ms", iters, ALPHA,
                                                       early_stop=False)
        for key, fn in fns.items():
            fn(synds[5])
            t[key] = _median_ms(fn, synds[:5])
        # the shot-iterations these batches need (the early exit's data-dependent work)
        t[f"K1_{tag}_shot_iters"] = float(np.mean([int(fns[f"K1_{tag}"](s)[3].sum())
                                                   for s in synds[:5]]))

    pair("bench", H, 1024, 32, 1e-3)               # bench_bp's configuration
    pair(f"S{shots}", Hss, shots, MAX_ITER, FLAT_P)
    pair(f"S{shots}_es", Hss, shots, MAX_ITER, FLAT_P, early_stop=True)
    # the host BP+OSD redecode's shape: a few hundred shots, early exit
    pair(f"S{S_REDECODE}_es", Hss, S_REDECODE, MAX_ITER, FLAT_P, early_stop=True)
    pair(f"S{S_REDECODE}", Hss, S_REDECODE, MAX_ITER, FLAT_P)
    pair("n40000", big, 256, 8, 2e-3)
    # K1's cooperative route (one launch) against one grid per phase, at the
    # shapes where the plan takes it
    for tag, fs, S, iters, p, es in (
            (f"S{S_REDECODE}_es", Hss, S_REDECODE, MAX_ITER, FLAT_P, True),
            ("bench", H, 1024, 32, 1e-3, False)):
        prior, sb = fs.prior(p), k1.auto_shot_block(fs.layout)
        synds = [fs.syndromes(S, p, seed=300 + i) for i in range(6)]

        def fn(s, fs=fs, prior=prior, iters=iters, es=es, sb=sb):
            return k1.bsr_bp_decode(fs.layout, prior, s, "ms", iters, ALPHA, es, sb)
        k1.COOPERATIVE = False
        try:
            fn(synds[5])
            t[f"K1_{tag}_grids"] = _median_ms(fn, synds[:5])
        finally:
            k1.COOPERATIVE = True
    # K6's streamed route (the device-memory grids) at the main shape
    prior = Hss.prior(FLAT_P)
    synds = [Hss.device_syndromes(shots, FLAT_P, seed=300 + i) for i in range(6)]
    streamed = k6.launch_plan(Hss.tables, shots, dev, route="streamed")
    k6.bp_fixed(Hss.tables, prior, synds[5], "ms", MAX_ITER, ALPHA, plan=streamed)
    t[f"K6_S{shots}_streamed"] = _median_ms(
        lambda s: k6.bp_fixed(Hss.tables, prior, s, "ms", MAX_ITER, ALPHA, plan=streamed),
        synds[:5])
    for fs, n in ((Hss, shots), (Hss, S_REDECODE), (H, 1024)):
        log(f"  K6 plan at {fs.name} S={n}: {_plan_tag(k6.launch_plan(fs.tables, n, dev))}")
    for k, v in t.items():
        if not k.endswith("_shot_iters"):
            old = f" (before: {OLD_KERNEL_MS[k]} ms)" if k in OLD_KERNEL_MS else ""
            log(f"  {k}: {v:.4f} ms{old}")
    log(f"  K1 at bench_bp's configuration: {32 * 1024 / t['K1_bench'] * 1e3:.4g} iter*shots/s "
        f"(plain {32 * 1024 / t['K1_bench_plain'] * 1e3:.4g})")
    with CODE_FILE.open() as f:
        code = read_quantum_code(f, validate_stabilizer_code=True)
    p = P_MODES[0]
    for mode in ("bposd_single_shot", "bposd_hybrid"):
        pipe = StorageDecodePipeline(
            code=code, rounds=ROUNDS, noise_model=depolarizing_noise(p, p),
            data_prior=2 / 3 * p, meas_prior=2 / 3 * p, shots_per_device=shots,
            max_iter=MAX_ITER, bp_method="ms", ms_scaling_factor=ALPHA, osd_fallback_cap=shots,
            osd_options=dict(OPTIONS), mode=mode, device=dev)
        gens = []
        for i in range(6):
            g = torch.Generator(device=dev)
            g.manual_seed(400 + i)
            gens.append(g)
        pipe.run_bposd(gens[5])
        stages = {"sample": [], "device_decode": [], "host_osd": [], "e2e": [], "osd_shots": []}
        for g in gens[:5]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            record = pipe._sample(g, pipe._noise_args)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = pipe._decode_records(record)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            _f, _n, osd = pipe._finish_bposd(*out)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            for k, v in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t3 - t0, osd)):
                stages[k].append(v)
        for k, v in stages.items():
            t[f"{mode}_{k}" + ("" if k == "osd_shots" else "_s")] = float(np.median(v))
        log(f"  {mode}: " + ", ".join(f"{k} {np.median(v):.4f}" for k, v in stages.items())
            + f"; end to end {shots / t[f'{mode}_e2e_s']:.0f} decoded shots/s at p={p:.6g}")
    return t


# ---------------------------------------------------------------------------
# Check-partition BP (K4), the model axis, and K3 in the K3b regime
# ---------------------------------------------------------------------------

SHARD_ITERS = 24


def _k4(dec, synd, iterate=k4.bsr_shard_iter, max_iter=None):
    """A check-partition decode as (hard, posterior, conv, iters) over the
    code's columns (the iteration count is fixed)."""
    h, p, c = dec.decode_tensors(synd, max_iter=max_iter, iterate=iterate)
    V = dec.sharded.num_vars
    n = dec.max_iter if max_iter is None else max_iter
    return h[:V], p[:V], c, torch.full_like(c, n, dtype=torch.int32)


def phase_k4(dev: torch.device, sizes, cap):
    log(f"== phase 13: K4 vs plain (check-partition decode), S in {sizes}, {SHARD_ITERS} "
        "iterations")
    fs = Checks(biregular_hgp(20, 3, 4, seed=1).checks.z, dev, "HGP n=625")
    p = 5e-3
    worst = 0.0
    for D in (1, 2, 3):
        for S in sizes:
            synd = fs.syndromes(S, p, seed=6)
            for method, msf in METHODS:
                dec = k4.ShardedBSRDecoder.from_check_matrix(
                    fs.H, D, error_rate=p, max_iter=SHARD_ITERS, bp_method=method,
                    ms_scaling_factor=msf, device=dev)
                kern = _k4(dec, synd)
                plain = _k4(dec, synd, k4.bsr_shard_iter_plain)
                torch.cuda.synchronize()
                worst = max(worst, _same(f"{fs.name} D={D} S={S} {method} alpha={msf}", fs,
                                         synd, kern, plain))
    # one iteration on ragged tensors (one shot per thread), stored and accumulated
    sb = k4.ShardedBSR.from_check_matrix(fs.H, 2)
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    for d in range(sb.num_shards):
        tab = sb.tables(d, dev)
        post = 3 + 4 * torch.randn((sb.v_pad, 97), generator=gen, device=dev)
        msgs = (2 * torch.randn((sb.e_loc, 97), generator=gen, device=dev)).to(torch.bfloat16)
        synd = (torch.rand((sb.c_pad_loc, 97), generator=gen, device=dev) < 0.1).to(torch.uint8)
        run = torch.randn((sb.v_pad, 97), generator=gen, device=dev)
        for method in ("ms", "ps"):
            mk, pk = k4.bsr_shard_iter(tab, post, msgs, synd, ALPHA, method)
            mp, pp = k4.bsr_shard_iter_plain(tab, post, msgs, synd, ALPHA, method)
            _m, ak = k4.bsr_shard_iter(tab, post, msgs, synd, ALPHA, method,
                                       out_part=run.clone(), accumulate=True)
            torch.cuda.synchronize()
            check(torch.equal(mk, mp) and torch.equal(pk, pp) and torch.equal(ak, run + pp),
                  f"shard {d} of {sb.num_shards} {method}, S=97, one iteration: messages and "
                  "partials (stored, accumulated) equal to plain")
    if cap is None:
        return worst, None
    H, cap_dec, rec = cap
    big = Checks(H, dev, "HGP n=40000")
    D = rec["shards"]
    check(D == 8, f"{big.name}: auto_num_shards = {D} (the JAX demo's 8)")
    synd = big.syndromes(128, 5e-4, seed=7)
    worst_big = 0.0
    for method in ("ms", "ps"):   # the demo's decoder: adaptive min-sum, 32 iterations
        dec = replace(cap_dec, method=method)
        msf = dec.ms_scaling_factor
        kern = _k4(dec, synd)
        plain = _k4(dec, synd, k4.bsr_shard_iter_plain)
        torch.cuda.synchronize()
        worst_big = max(worst_big, _same(f"{big.name} D={D} S=128 {method} alpha={msf}", big,
                                         synd, kern, plain))
    return worst, worst_big


def _shard_case(dev: torch.device):
    """tests/test_bp_bsr_shard.py's case: n = 625 HGP, 128 shots at p = 0.01."""
    fs = Checks(biregular_hgp(20, 3, 4, seed=1).checks.z, dev, "HGP n=625")
    return fs, fs.syndromes(128, 0.01, seed=0)


def phase_k4_vs_k1(dev: torch.device) -> None:
    log(f"== phase 14: check-partition decode on K4 vs K1 at fixed iterations, "
        f"{SHARD_ITERS} iterations")
    fs, synd = _shard_case(dev)
    layout = k1.BSRLayout.from_tanner(TannerELL.from_check_matrix(fs.H), dev)
    prior = fs.prior(0.01)
    for method, msf in METHODS:
        hr, _pr, cr, _ir = k1.bsr_bp_decode(layout, prior, synd, method, SHARD_ITERS, msf,
                                            False, k1.auto_shot_block(layout))
        for D in (1, 2, 3):
            dec = k4.ShardedBSRDecoder.from_check_matrix(
                fs.H, D, error_rate=0.01, max_iter=SHARD_ITERS, bp_method=method,
                ms_scaling_factor=msf, device=dev)
            h, _p, c, _i = _k4(dec, synd)
            torch.cuda.synchronize()
            check(torch.equal(h, hr) and torch.equal(c, cr),
                  f"D={D} {method} alpha={msf}: hard and conv equal to K1 "
                  f"(conv rate {float(c.float().mean()):.4f})")


def phase_shard_capacity(cap) -> dict:
    log("== phase 15: main path of the model axis: shard_capacity at full size")
    H, dec, rec = cap
    rec = dict(rec)
    reset_counts()
    rec.update(shard_capacity.run(H, dec))
    torch.cuda.synchronize()
    launches = launch_counts()
    log(f"  {json.dumps(rec)}")
    log(f"  kernel launches: {launches}")
    D = rec["shards"]
    check(launches["K4"] == 2 * D * dec.max_iter,
          f"K4 launched once per shard per iteration ({launches['K4']} = 2 decodes x {D} x "
          f"{dec.max_iter})")
    return launches


def _dist_rank(rank: int, world: int) -> dict:
    """One rank of phase 16 (runs in its own process)."""
    mesh = make_mesh(model_parallel=2, device="cuda")
    fs, synd = _shard_case(mesh.device)
    dec = k4.ShardedBSRDecoder.from_check_matrix(fs.H, 2, mesh=mesh, error_rate=0.01,
                                                 max_iter=SHARD_ITERS, bp_method="ms")
    k4.KERNEL.launches = 0
    hard, post, conv = dec.decode_batch(synd.cpu().numpy().T)
    torch.cuda.synchronize()
    return {"hard": hard, "post": post, "conv": conv, "launches": k4.KERNEL.launches,
            "device": str(mesh.device), "coords": mesh.coords}


def dist_world():
    """Phase 16's two ranks: (their results, seconds from start to join)."""
    t0 = time.perf_counter()
    ranks = run_world(_dist_rank, 2, backend="gloo", timeout=300, threads=None)
    return ranks, time.perf_counter() - t0


def phase_distributed(dev: torch.device, world) -> dict:
    log("== phase 16: two ranks on the card, model axis 2, gloo")
    ranks, secs = world.result()
    log(f"  two ranks ran in {secs:.1f} s (beside phases 3-5) on "
        f"{[r['device'] for r in ranks]}, coords {[r['coords'] for r in ranks]}")
    fs, synd = _shard_case(dev)
    eh, ep, ec = k4.ShardedBSRDecoder.from_check_matrix(
        fs.H, 2, error_rate=0.01, max_iter=SHARD_ITERS, bp_method="ms",
        device=dev).decode_batch(synd.cpu().numpy().T)
    for k, r in enumerate(ranks):
        d = float(np.abs(r["post"] - ep).max())
        check(np.array_equal(r["hard"], eh) and np.array_equal(r["conv"], ec) and d == 0.0,
              f"rank {k}: hard, conv and posteriors equal to the emulated D=2 decode "
              f"(max |dpost| {d}, conv rate {float(ec.mean()):.4f})")
        check(r["launches"] == SHARD_ITERS, f"rank {k}: K4 launched {r['launches']} times")
    counts = {name: 0 for name in KERNELS}
    counts["K4"] = sum(r["launches"] for r in ranks)
    MAIN_ROUTES["K4"]["default"] = MAIN_ROUTES["K4"].get("default", 0) + counts["K4"]
    return counts


def phase_k3b(dev: torch.device, t: dict):
    """Returns the worst posterior error, the K3 launches of the kernel
    decodes (counted from 0) and, by code tag, the shape each was timed at
    (the spacetime ``Checks``, the base tables, shots, iterations)."""
    rounds, S, iters, p = 8, 128, 32, 1e-3
    log(f"== phase 17: K3 vs plain in the K3b regime, {rounds} rounds, S={S}, {iters} "
        "iterations")
    codes = {
        "cyclic n=4862": lifted_product_code_cyclic(
            q=22, m=1, w=14, r=5, seed=42, compute_logicals=False).checks.z,
        "HGP n=10000": biregular_hgp(80, 3, 4, seed=7, compute_logicals=False).checks.z}
    worst, launches, shapes = 0.0, 0, {}
    plain = k3._stbsr_iter_plain
    methods = (("ms", ALPHA), ("ps", 0.0))
    for name, H in codes.items():
        tanner = TannerELL.from_check_matrix(H)
        tiles = k1.BSRLayout.from_tanner(tanner, dev).num_tiles
        check(tiles >= 64, f"{name}: {tiles} BSR tiles (>= 64: the JAX package selects K3b)")
        tables = tanner_tables(tanner, dev)
        st = Checks(SpacetimeCode(H, rounds).spacetime_check_matrix, dev,
                    f"{name} x{rounds} rounds")
        prior = st.prior(p)
        synd = st.syndromes(S, p, seed=40)
        tag = name.split()[0]
        shapes[tag] = (st, tables, S, iters)
        for method, msf in methods:
            args = (tables, rounds, prior, synd, method, iters, msf, False)
            reset_counts()
            kern, ms = _timed(lambda: k3.stbsr_decode(*args))
            launches += k3.KERNEL.launches
            ref, ms_plain = _timed(lambda: k3.stbsr_decode(*args, iterate=plain))
            worst = max(worst, _same(f"{st.name} {method} alpha={msf}", st, synd, kern, ref))
            log(f"  {name} {method}: K3 {ms:.3f} ms, plain {ms_plain:.3f} ms per decode "
                "(one run)")
            if method == "ms":
                t[f"K3b_{tag}"], t[f"K3b_{tag}_plain"] = ms, ms_plain
    check(launches > 0, f"K3 launched {launches} times at K3b's sizes (one call per decode)")
    return worst, launches, shapes


def phase_shard_timings(dev: torch.device, cap, cyclic_H) -> dict:
    log("== phase 18: K4 per decode iteration (all shards) vs plain and K1, "
        "shard_capacity.per_iter_slope (4 -> 12 iterations, best of 2)")
    t = {}

    def per_iter(tag, H, decs, S, p):
        layout = k1.BSRLayout.from_tanner(TannerELL.from_check_matrix(H), dev)
        prior = torch.as_tensor(priors_to_llr(np.full(H.shape[1], p))).to(dev)
        sb = k1.auto_shot_block(layout)
        fns = {f"K1_shard_{tag}": lambda s, n: k1.bsr_bp_decode(layout, prior, s, "ms", n,
                                                                ALPHA, False, sb)}
        for D, dec in decs:
            fns[f"K4_{tag}_D{D}"] = lambda s, n, dec=dec: dec.decode_tensors(s, max_iter=n)
            fns[f"K4_{tag}_D{D}_plain"] = lambda s, n, dec=dec: dec.decode_tensors(
                s, max_iter=n, iterate=k4.bsr_shard_iter_plain)
        for key, fn in fns.items():
            t[key] = 1e3 * shard_capacity.per_iter_slope(fn, H, dev, S, p, lo=4, hi=12, nrep=2)
        for D, _dec in decs:
            log(f"  {tag} D={D} S={S}: K4 {t[f'K4_{tag}_D{D}']:.4f}, plain "
                f"{t[f'K4_{tag}_D{D}_plain']:.4f}, K1 {t[f'K1_shard_{tag}']:.4f} ms per "
                "iteration")

    H, dec, rec = cap
    per_iter("capacity", H, [(rec["shards"], dec)], 128, 5e-4)
    H = cyclic_H
    per_iter("bench", H, [(D, k4.ShardedBSRDecoder.from_check_matrix(
        H, D, error_rate=1e-3, max_iter=32, bp_method="ms", device=dev)) for D in (1, 2, 4)],
             1024, 1e-3)
    return t


# ---------------------------------------------------------------------------
# The int8 kernel K5 and the code-family benchmark
# ---------------------------------------------------------------------------

FAM_SHOTS, FAM_ITERS, FAM_P = 1024, 32, 1e-3


def family_setups(dev: torch.device, cyclic_H):
    """The two codes of the family path's kernel rows: the QC-LP
    [[1054,140]] as the benchmark builds it, and the cyclic n = 4,862 in QC
    order (``bench_bsr_shard.build_code``, the matrix phase 18 times too)."""
    return [FlatSetup(bench_large_codes._qclp_H(), dev, "qclp"),
            FlatSetup(cyclic_H, dev, "cyclic")]


def _prior_q(fs: Checks, p: float) -> torch.Tensor:
    return torch.as_tensor(quantize_priors(fs.prior(p).cpu().numpy())[0]).to(fs.dev)


def _k5_case(fs: FlatSetup, synd, prior_q, alpha_num, early_stop, iters, sb) -> int:
    """One K5 decode against its plain version; the largest difference of
    the posterior quanta (every output is also required equal)."""
    before = k1.KERNEL_INT8.launches
    kern = k1.bsr_bp_decode_int8(fs.layout, prior_q, synd, iters, alpha_num, early_stop, sb)
    plain = k1.bsr_bp_int8_plain(fs.layout, prior_q, synd, iters, alpha_num, early_stop, sb)
    torch.cuda.synchronize()
    check(k1.KERNEL_INT8.launches == before + 1, f"{fs.name}: one K5 call per decode")
    tag = (f"{fs.name} S={synd.shape[1]} sb={sb} alpha_num={alpha_num} early_stop={early_stop} "
           f"(conv rate {float(plain[2].float().mean()):.4f}, block iters "
           f"{kern[3][::sb].tolist()[:8]}) [{_bsr_plan_tag(fs, synd.shape[1], sb, True)}]")
    same = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(kern, plain))
    check(same, f"{tag}: posterior quanta, hard, conv and iters equal to plain")
    check(bool(fs.valid(kern[0], synd)[kern[2]].all()),
          f"{fs.name}: every conv=1 shot satisfies its syndrome")
    return int((kern[1].to(torch.int64) - plain[1].to(torch.int64)).abs().max())


def phase_k5(flats, fams, sizes, dev: torch.device) -> float:
    log(f"== phase 19: K5 vs plain (int8, exact), S in {sizes}, {MAX_ITER} iterations; shot "
        f"blocks exiting apart, S in {S_EXIT}, blocks of {SB_EXIT}; the family codes at "
        f"S={FAM_SHOTS}, {FAM_ITERS} iterations")
    worst = 0
    for fs in flats:
        prior_q = _prior_q(fs, FLAT_P)
        sb = k1.auto_shot_block(fs.layout)
        for S in sizes:
            synd = fs.syndromes(S, FLAT_P, seed=8)
            for alpha_num, es in ((160, False), (160, True), (256, False)):
                worst = max(worst, _k5_case(fs, synd, prior_q, alpha_num, es, MAX_ITER, sb))
        for S in S_EXIT:
            synd = _mixed_syndromes(fs, S, seed=12)
            for sb in SB_EXIT:
                for alpha_num, es in ((160, True), (256, False)):
                    worst = max(worst, _k5_case(fs, synd, prior_q, alpha_num, es, MAX_ITER, sb))
    for fs in fams:
        prior_q = _prior_q(fs, FAM_P)
        synd = fs.syndromes(FAM_SHOTS, FAM_P, seed=9)
        for es in (False, True):
            worst = max(worst, _k5_case(fs, synd, prior_q, 160, es, FAM_ITERS, 128))
    fs = flats[0]
    synd = fs.syndromes(64, 0.01, seed=10)
    pq = quantize_priors(priors_to_llr(np.full(fs.H.shape[1], 0.01)))[0]
    got = int8_bp_core(fs.tables, torch.as_tensor(pq).to(dev), synd, 12, 160, False)
    want = int8_bp_oracle(fs.H, pq, synd.cpu().numpy(), 12, 160)
    check(all(np.array_equal(g.cpu().numpy(), w) for g, w in zip(got[:3], want)),
          "int8_bp_core on the card equals the numpy oracle (hard, posterior quanta, conv)")
    return float(worst)


FAMILY_ROWS = {"qclp_1054_140": ("gather", "qc-roll", "bsr", "bsr-int8"),
               "cyclic_lp_4862": ("bsr", "bsr-int8")}


def phase_families(dev: torch.device):
    """The family benchmark's own ``main``; returns (launches, rows by
    (code, formulation))."""
    log(f"== phase 20: code-family path: bench_large_codes, {FAM_SHOTS} shots x {FAM_ITERS} "
        f"iterations, p={FAM_P}")
    common = ["--shots", str(FAM_SHOTS), "--iters", str(FAM_ITERS), "--p", str(FAM_P),
              "--reps-lo", "1", "--reps-hi", "3", "--device", str(dev)]
    reset_counts()
    recs = bench_large_codes.main(common + ["--only", "qclp_1054_140"])
    recs += bench_large_codes.main(common + ["--only", "cyclic_lp_4862/bsr"])
    torch.cuda.synchronize()
    launches = launch_counts()
    log(f"  kernel launches: {launches}")
    rows = {(r["code"], r["formulation"].split("[")[0].split("(")[0]): r for r in recs}
    check(sorted(rows) == sorted((c, f) for c, fs in FAMILY_ROWS.items() for f in fs),
          f"rows {sorted(rows)}")
    for name in ("K1", "K5"):
        check(launches[name] > 0, f"{name} launched on the family path ({launches[name]})")
    for r in recs:
        check(np.isfinite(r["bp_iter_shots_per_s"]) and r["bp_iter_shots_per_s"] > 0
              and r["time_kind"] == "slope" and r["device"] == torch.cuda.get_device_name(0),
              f"{r['code']}/{r['formulation']}: {r['bp_iter_shots_per_s']:.4g} iter*shots/s, "
              f"{1e3 * FAM_ITERS * FAM_SHOTS / r['bp_iter_shots_per_s']:.3f} ms per decode, "
              f"converged {r['bp_converged_frac']:.4f}")
    # Accuracy.  int8 min-sum must not converge less often than bf16 (its
    # saturation at +-127 quanta damps the messages: at the cyclic code it
    # converges MORE often, in the reference too), and each kernel row's
    # converged share must agree with the reference's own row of
    # artifacts/bp_families_v5e.jsonl (a count of decoded shots, not a time)
    # within 4 combined binomial sigma.
    ref = {}
    for line in FAMILIES_ARTIFACT.read_text().splitlines():
        r = json.loads(line)
        ref[r["code"], r["formulation"].split("[")[0]] = r
    for code in FAMILY_ROWS:
        a, b = rows[code, "bsr"]["bp_converged_frac"], rows[code, "bsr-int8"]["bp_converged_frac"]
        check(b >= a - 0.02, f"{code}: converged share bsr-int8 {b:.4f} not below bsr {a:.4f}")
        for f in ("bsr", "bsr-int8"):
            got, want = rows[code, f]["bp_converged_frac"], ref[code, f]["bp_converged_frac"]
            n, n_ref = FAM_SHOTS, 4 * ref[code, f]["shots"]   # the script's reps_lo is 4
            sigma = np.sqrt(got * (1 - got) / n + want * (1 - want) / n_ref)
            check(abs(got - want) <= 4 * max(sigma, 1 / n),
                  f"{code}/{f}: converged share {got:.4f} vs the reference's {want:.4f} "
                  f"({abs(got - want) / max(sigma, 1 / n):.2f} sigma)")
    return launches, rows


def phase_family_timings(fams, rows) -> dict:
    log("== phase 21: K5 and K1 against their plain versions at the family codes "
        f"(S={FAM_SHOTS}, {FAM_ITERS} iterations, median of 3 distinct batches)")
    t = {}
    names = {"qclp": "qclp_1054_140", "cyclic": "cyclic_lp_4862"}
    for fs in fams:
        prior, prior_q = fs.prior(FAM_P), _prior_q(fs, FAM_P)
        synds = [fs.syndromes(FAM_SHOTS, FAM_P, seed=500 + i) for i in range(4)]
        fns = {
            f"K1_fam_{fs.name}": lambda s: k1.bsr_bp_decode(fs.layout, prior, s, "ms", FAM_ITERS,
                                                           ALPHA, False, 128),
            f"K1_fam_{fs.name}_plain": lambda s: k1.bsr_bp_plain(fs.layout, prior, s, "ms",
                                                                 FAM_ITERS, ALPHA, False, 128),
            f"K5_{fs.name}": lambda s: k1.bsr_bp_decode_int8(fs.layout, prior_q, s, FAM_ITERS,
                                                             160, False, 128),
            f"K5_{fs.name}_plain": lambda s: k1.bsr_bp_int8_plain(fs.layout, prior_q, s,
                                                                  FAM_ITERS, 160, False, 128)}
        for key, fn in fns.items():
            fn(synds[3])
            t[key] = _median_ms(fn, synds[:3])
        per = {f: 1e3 * FAM_ITERS * FAM_SHOTS / rows[names[fs.name], f]["bp_iter_shots_per_s"]
               for f in FAMILY_ROWS[names[fs.name]]}
        was = {k: f" (before: {OLD_KERNEL_MS[k]})" if k in OLD_KERNEL_MS else ""
               for k in (f"K1_fam_{fs.name}", f"K5_{fs.name}")}
        log(f"  {names[fs.name]} ms per decode: bsr (K1) {t[f'K1_fam_{fs.name}']:.3f}"
            f"{was[f'K1_fam_{fs.name}']} (row {per['bsr']:.3f}), plain "
            f"{t[f'K1_fam_{fs.name}_plain']:.3f}; bsr-int8 (K5) {t[f'K5_{fs.name}']:.3f}"
            f"{was[f'K5_{fs.name}']} (row {per['bsr-int8']:.3f}), plain "
            f"{t[f'K5_{fs.name}_plain']:.3f}"
            + "".join(f"; {f} {per[f]:.3f} (plain PyTorch itself)" for f in per
                      if not f.startswith("bsr")))
    return t


# ---------------------------------------------------------------------------
# K1 and K5 at check degree 53 (route "wide"), and the host path of p_sweep
# ---------------------------------------------------------------------------

DEM_P = 1e-3          # circuit noise of HGP-225's 1-round detector error model
DEM_SIZES = (97, 4096)


class PriorSetup(FlatSetup):
    """A check matrix on the card with a prior per column: a detector
    model's fault priors, or a window's data and measurement priors."""

    def __init__(self, H, priors, dev: torch.device, name: str):
        super().__init__(H, dev, name)
        self.priors = np.asarray(priors, dtype=np.float64)

    def draw(self, S: int, seed: int, scale: float = 2.0) -> torch.Tensor:
        """(checks, S) syndromes of faults drawn at ``scale`` times their priors."""
        rng = np.random.default_rng(seed)
        err = (rng.random((S, self.H.shape[1]), dtype=np.float32)
               < scale * self.priors).astype(np.int64)
        return torch.as_tensor(((self.H @ err.T) % 2).astype(np.uint8)).to(self.dev)

    def prior_llr(self) -> torch.Tensor:
        return torch.as_tensor(priors_to_llr(self.priors)).to(self.dev)


def dem_matrix(code):
    """(fault matrix, fault priors) of the code's 1-round circuit-noise DEM
    (~8 s of host work, built in a thread beside the kernel build)."""
    sim = build_storage_simulation(1, circuit_noise(DEM_P, DEM_P), code)
    dsc = DetectorSpacetimeCode(detector_error_model(sim.circuit))
    return dsc.fault_check_matrix, dsc.fault_priors


def phase_dem_kernels(dem: PriorSetup, timings: bool):
    """K1 and K5 against their plain versions at check degree 53; returns
    (K1's worst posterior error, K5's worst quanta difference, times)."""
    t = dem.layout.tables
    log(f"== phase 22: K1 and K5 vs plain at check degree {t.max_check_degree} (route wide): "
        f"HGP-225's 1-round circuit-noise detector model {dem.H.shape[0]} x {dem.H.shape[1]}, "
        f"S in {DEM_SIZES}, {MAX_ITER} iterations, fixed and with the early exit")
    check(dem.H.shape == (216, 1518) and t.max_check_degree == 53,
          "the detector model's fault matrix is 216 x 1,518 with check degree 53")
    prior = dem.prior_llr()
    prior_q = torch.as_tensor(quantize_priors(prior.cpu().numpy())[0]).to(dem.dev)
    sb = k1.auto_shot_block(dem.layout)
    wide = (k1.KERNEL.routes.get("wide", 0), k1.KERNEL_INT8.routes.get("wide", 0))
    worst1, worst5 = 0.0, 0
    for S in DEM_SIZES:
        synd = dem.draw(S, seed=20 + S)
        for method, msf in (("ms", ALPHA), ("ps", 0.0)):
            for es in (False, True):
                worst1 = max(worst1, _k1_case(dem, synd, prior, method, msf, es, MAX_ITER))
        for es in (False, True):
            worst5 = max(worst5, _k5_case(dem, synd, prior_q, 160, es, MAX_ITER, sb))
    check((k1.KERNEL.routes.get("wide", 0) - wide[0],
           k1.KERNEL_INT8.routes.get("wide", 0) - wide[1]) == (4 * len(DEM_SIZES),
                                                                2 * len(DEM_SIZES)),
          "every K1 and K5 decode of this phase took route wide")
    times = {}
    if timings:   # min-sum, 4,096 shots x 48 iterations, fixed; median of 5 distinct batches
        synds = [dem.draw(4096, seed=40 + i) for i in range(6)]
        L = dem.layout
        fns = {"K1_dem_dc53": lambda s: k1.bsr_bp_decode(L, prior, s, "ms", MAX_ITER, ALPHA,
                                                        False, sb),
               "K1_dem_dc53_plain": lambda s: k1.bsr_bp_plain(L, prior, s, "ms", MAX_ITER,
                                                              ALPHA, False, sb),
               "K5_dem_dc53": lambda s: k1.bsr_bp_decode_int8(L, prior_q, s, MAX_ITER, 160,
                                                             False, sb),
               "K5_dem_dc53_plain": lambda s: k1.bsr_bp_int8_plain(L, prior_q, s, MAX_ITER, 160,
                                                                   False, sb)}
        for key, fn in fns.items():
            fn(synds[5])
            times[key] = _median_ms(fn, synds[:5])
            log(f"  {key}: {times[key]:.4f} ms (4096 x {MAX_ITER})")
    return worst1, worst5, times


def host_path_matrices(code):
    """[(name, matrix, priors, shots, options)] of the matrices phase 23
    decodes on K1 beyond phase 10's H and (H|I): ``bpd_detector``'s fault
    matrix (4 rounds of phenomenological noise at p = 0.002, as
    ``run_simulation`` builds it) and ``sliding_window``'s window matrix
    and 4-round exact tail (priors as ``SlidingWindowDecoder`` sets them).
    ~8 s of host work, in a thread beside the kernel build."""
    p = 0.002
    sim = build_storage_simulation(ROUNDS, depolarizing_noise(p=p, pm=p), code)
    dsc = DetectorSpacetimeCode(detector_error_model(sim.circuit))
    H = code.checks.z
    r, n = H.shape
    w, q = SW_WINDOW, 2 / 3 * SW_P
    tail = SpacetimeCode(H, w).spacetime_check_matrix
    return [("pheno_dem_4r", dsc.fault_check_matrix, dsc.fault_priors, HOST_SHOTS,
             ANCHOR_OPTIONS),
            (f"window_{w}", window_check_matrix(H, w), np.full(w * (n + r), q), SW_SHOTS,
             OPTIONS),
            (f"tail_{w}r", tail, np.full(tail.shape[1], q), SW_SHOTS, OPTIONS)]


def phase_host_path_kernels(setups) -> float:
    """K1 against its plain version at phase 23's other K1 matrices, at the
    shots and options phase 23 gives each; the first half of the shots'
    faults are drawn at their priors (at the window matrices most shot
    blocks then exit within a few iterations), the second half at four
    times them (blocks that run to the last iteration).  Returns the worst
    posterior error."""
    log("== phase 22 (cont.): K1 vs plain at the matrices phase 23 decodes on K1: "
        + ", ".join(f"{fs.name} {fs.H.shape[0]} x {fs.H.shape[1]} (Dc "
                    f"{fs.tables.max_check_degree}), S={S}" for fs, S, _o in setups))
    worst = 0.0
    for i, (fs, S, opts) in enumerate(setups):
        check(flat_choice(TannerELL.from_check_matrix(fs.H), fs.dev) == "K1",
              f"{fs.name}: the selection sends it to K1 on the card (its BP+OSD asks the "
              "early exit)")
        prior = torch.as_tensor(priors_to_llr(fs.priors)).to(fs.dev)
        synd = torch.cat([fs.draw(S // 2, seed=50 + i, scale=1.0),
                          fs.draw(S - S // 2, seed=60 + i, scale=4.0)], dim=1)
        iters = opts["max_iter"]
        for method, msf in (("ms", float(opts["ms_scaling_factor"])), ("ps", 0.0)):
            for es in (False, True):
                worst = max(worst, _k1_case(fs, synd, prior, method, msf, es, iters))
    return worst


RUNSIM_ARTIFACT = ROOT / "artifacts" / "run_simulation_modes_jax_cpu.jsonl"
SLIDING_ARTIFACT = ROOT / "artifacts" / "sliding_window_v5e.jsonl"
# the options of the modes anchored by RUNSIM_ARTIFACT (tests/test_decoders.py's, min-sum)
ANCHOR_OPTIONS = dict(max_iter=40, bp_method="ms", ms_scaling_factor=0, osd_method="osd_cs",
                      osd_order=4)
HOST_SHOTS = 16384
SW_ROUNDS, SW_SHOTS, SW_P, SW_WINDOW, SW_COMMIT = 64, 4096, 0.001, 4, 2


def _runsim_anchor(mode: str):
    for line in RUNSIM_ARTIFACT.read_text().splitlines():
        rec = json.loads(line)
        if rec["mode"] == mode:
            return rec["failures"] / rec["samples"], rec["samples"], RUNSIM_ARTIFACT.name
    raise KeyError(mode)


def _sliding_anchor():
    for line in SLIDING_ARTIFACT.read_text().splitlines():
        rec = json.loads(line)
        if rec.get("bench") == "sliding_window" and rec["rounds"] == SW_ROUNDS:
            return rec["failures"] / rec["shots"], rec["shots"], SLIDING_ARTIFACT.name
    raise KeyError(SW_ROUNDS)


def host_cases():
    """(mode, p, rounds, shots, options, (anchor LER, anchor shots, source),
    kernels the run must launch) of the host-path phase."""
    art = artifact_point(P_HI)
    modes = {m: modes_artifact(m, 0.002) for m in ("bposd_single_shot", "bposd_hybrid")}
    # the kernels of each run by the selection: every BP+OSD asks the early exit,
    # so K3 for HGP-225 x4's spacetime matrix and K1 for the flat matrices
    return [
        ("bposd", P_HI, ROUNDS, HOST_SHOTS, OPTIONS, (art["ler"], art["samples"], ARTIFACT.name),
         ("K3",)),
        *[(m, 0.002, ROUNDS, HOST_SHOTS, OPTIONS,
           (int(r["failures"]) / int(r["samples"]), int(r["samples"]), MODES_ARTIFACT.name),
           ("K1",) + (("K3",) if m == "bposd_hybrid" else ())) for m, r in modes.items()],
        *[(m, 0.002, ROUNDS, HOST_SHOTS, ANCHOR_OPTIONS, _runsim_anchor(m),
           ("K1",) if m == "bpd_detector" else ())
          for m in ("bpd_detector", "relay_bp", "ssf_single_shot")],
        ("sliding_window", SW_P, SW_ROUNDS, SW_SHOTS,
         dict(OPTIONS, window_size=SW_WINDOW, window_commit=SW_COMMIT), _sliding_anchor(),
         ("K1",)),
    ]


def _host_sweep(code, dev, mode, p, rounds, shots, opts, noise=depolarizing_noise):
    return p_sweep(
        samples=shots, p_values=np.array([p]), noise_model=noise,
        noise_model_args=lambda p: {"p": p, "pm": p},
        meas_prior=lambda p, xs, zs: 2 / 3 * p, data_prior=lambda p, xs, zs: 2 / 3 * p,
        seed=31, pipeline=None, device=dev, code=code, rounds=rounds, decoder_mode=mode,
        bp_osd_options=dict(opts))[0]


def phase_host_path(code, dev: torch.device):
    """Every mode of run_simulation through p_sweep without a pipeline (the
    device sampler on the card); returns (launches by run, shots/s by mode).
    ``code`` is ``biregular_hgp(12, 3, 4, seed=0, compute_logicals=True)``,
    the object the anchors were made with: a mode that leaves shots
    unconverged (small-set-flip) scores them with the code's logical
    representatives, and ``artifacts/hgp225.qecc`` holds other ones (on
    identical records 131 against 95 failures of 4,096)."""
    log(f"== phase 23: the host path: p_sweep(..., pipeline=None) -> run_simulation in all "
        f"seven modes on HGP-225, device sampler, {HOST_SHOTS} shots "
        f"(sliding_window {SW_SHOTS} x {SW_ROUNDS} rounds, window 4, commit 2)")
    by_run, rates = {}, {}
    for mode, p, rounds, shots, opts, (ler_ref, n_ref, src), needs in host_cases():
        reset_counts()
        rec = _host_sweep(code, dev, mode, p, rounds, shots, opts)
        torch.cuda.synchronize()
        launches = launch_counts()
        rates[mode] = rec["samples"] / rec["walltime"]
        log(f"  {mode} p={p:.6g} rounds={rounds}: failures {rec['failures']}, shots "
            f"{rec['samples']}, {rates[mode]:.0f} shots/s ({rec['walltime']:.2f} s), launches "
            f"K1 {launches['K1']} K2 {launches['K2']} K3 {launches['K3']}")
        check(rec["samples"] == shots and 0 <= rec["failures"] <= shots,
              f"{mode}: one result per shot")
        check(_ler_gap(rec["failures"], rec["samples"], ler_ref, n_ref, f"{mode} p={p:.6g}"),
              f"{mode}: LER within 4 sigma of {src}")
        for name in needs:
            check(launches[name] > 0, f"{mode}: {name} launched on the host path")
        by_run[f"run_simulation_{mode}"] = launches
    # bpd_detector under circuit noise at 1 round: fault checks of 53 slots
    reset_counts()
    rec = _host_sweep(code, dev, "bpd_detector", DEM_P, 1, 4096, ANCHOR_OPTIONS,
                      noise=circuit_noise)
    torch.cuda.synchronize()
    wide = k1.KERNEL.routes.get("wide", 0)
    launches = launch_counts()
    rates["bpd_detector_circuit_1round"] = rec["samples"] / rec["walltime"]
    log(f"  bpd_detector, circuit noise p={DEM_P:g}, 1 round: failures {rec['failures']}, shots "
        f"{rec['samples']}, {rates['bpd_detector_circuit_1round']:.0f} shots/s "
        f"({rec['walltime']:.2f} s), K1 launches {launches['K1']} ({wide} on route wide)")
    check(rec["samples"] == 4096 and rec["failures"] < 4096 // 2,
          "bpd_detector under circuit noise: one result per shot, most shots decoded")
    check(launches["K1"] > 0 and wide == launches["K1"],
          "bpd_detector under circuit noise launched K1, every call on route wide")
    by_run["run_simulation_bpd_detector_circuit"] = launches
    return by_run, rates


# ---------------------------------------------------------------------------
# Route "wide" of K2, K3, K4 and K6; the two-tier decode; the rounds axis;
# the profiler trace
# ---------------------------------------------------------------------------

WIDE_ROUNDS, WIDE_ITERS, WIDE_P, WIDE_RAGGED = 4, 24, 5e-4, 97
WIDE_OPTIONS = dict(max_iter=WIDE_ITERS, bp_method="ms", ms_scaling_factor=ALPHA,
                    osd_method="osd0", osd_order=0)


def wide_matrix(rows: int, cols: int, lo: int, hi: int, seed: int):
    """A random check matrix with lo..hi distinct ones a row (the last row
    hi): checks past the register instances, some with padded slots.  K2's
    resident route "wide" needs one: no repo code with checks of more than
    30 slots fits a shot's spacetime state in shared memory."""
    from scipy import sparse

    rng = np.random.default_rng(seed)
    w = rng.integers(lo, hi + 1, rows)
    w[-1] = hi
    idx = np.concatenate([rng.choice(cols, k, replace=False) for k in w])
    return sparse.csr_matrix((np.ones(len(idx), np.int64), idx,
                              np.concatenate([[0], np.cumsum(w)])), (rows, cols))


def dense_hgp():
    """``biregular_hgp(32, 16, 16, seed=0)``: 2,048 qubits, 1,024 Z checks of
    degree 32 (34-slot spacetime checks, 33-slot (H|I) checks)."""
    return biregular_hgp(32, 16, 16, seed=0, compute_logicals=True)


def _time_pair(t: dict, key: str, kern_fn, plain_fn) -> None:
    """One timed run each (CUDA events; both warmed up by the parity run)."""
    t[key] = _timed(kern_fn)[1]
    t[f"{key}_plain"] = _timed(plain_fn)[1]
    log(f"  {key}: {t[key]:.3f} ms, plain {t[key + '_plain']:.3f} ms")


def phase_wide(code, dem: "PriorSetup", dev: torch.device, shots: int, timings: bool):
    """K2 (both routes), K3, K4 and K6 against their plain versions on route
    "wide"; returns (worst error by kernel, times, bounds, shapes)."""
    log(f"== phase 24: route wide: K3, K2 (streamed), K6 (streamed) at the dense HGP "
        f"x{WIDE_ROUNDS} rounds, {shots} shots x {WIDE_ITERS}; K2 (x2 rounds) and K6 resident at "
        f"a random 33-40 slot matrix; K4 at the Dc-53 DEM, D = 2 and 4")
    H = code.checks.z
    tables = tanner_tables(TannerELL.from_check_matrix(H), dev)
    check(tables.max_check_degree == 32, "dense HGP: Z checks of degree 32")
    st = Checks(SpacetimeCode(H, WIDE_ROUNDS).spacetime_check_matrix, dev,
                f"dense HGP x{WIDE_ROUNDS}")
    prior = st.prior(2 / 3 * WIDE_P)
    synd = st.device_syndromes(shots, WIDE_P, seed=41)
    ss = FlatSetup(SpacetimeCodeSingleShot(H).spacetime_check_matrix, dev, "dense HGP (H|I)")
    rand_H = wide_matrix(60, 300, 33, 40, seed=21)
    rtab = tanner_tables(TannerELL.from_check_matrix(rand_H), dev)
    rst = Checks(SpacetimeCode(rand_H, 2).spacetime_check_matrix, dev, "random 60x300 x2")
    worst = {k: 0.0 for k in ("K2", "K3", "K4", "K6")}
    before = {name: dict(kern.routes) for name, kern in KERNELS.items()}
    t, bounds, shapes = {}, {}, {}
    R, I = WIDE_ROUNDS, WIDE_ITERS
    # K3: the bposd device step, and a ragged host-redecode size
    for S in (shots, WIDE_RAGGED):
        s = synd[:, :S].contiguous()
        for method, msf in (("ms", ALPHA), ("ps", 0.0)):
            kern = k3.stbsr_decode(tables, R, prior, s, method, I, msf, False)
            plain = k3.stbsr_decode(tables, R, prior, s, method, I, msf, False,
                                    iterate=k3._stbsr_iter_plain)
            torch.cuda.synchronize()
            worst["K3"] = max(worst["K3"], _same(f"K3 {st.name} S={S} {method}", st, s, kern,
                                                 plain))
    # K2: the hybrid device step (one shot's state does not fit: streamed)
    plan = k2.launch_plan(tables, R, shots, dev)
    check(plan.route == "streamed" and plan.wide, f"K2 {st.name}: {plan.label}")
    for method, msf in (("ms", ALPHA), ("ps", 0.0)):
        kern = k2.stbp_fixed(tables, R, prior, synd, method, I, msf)
        plain = stbp_core(tables, R, prior, synd, method, I, msf, early_stop=False)
        torch.cuda.synchronize()
        worst["K2"] = max(worst["K2"], _same(f"K2 {st.name} {method} [{_plan_tag(plan)}]", st,
                                             synd, kern, plain))
    # K2's resident route "wide" at the random matrix
    rsynd = rst.syndromes(shots, 3e-3, seed=42)
    rprior = rst.prior(3e-3)
    plan = k2.launch_plan(rtab, 2, shots, dev)
    check(plan.route == "resident" and plan.wide, f"K2 {rst.name}: {plan.label}")
    for method, msf in (("ms", ALPHA), ("ps", 0.0)):
        kern = k2.stbp_fixed(rtab, 2, rprior, rsynd, method, I, msf)
        plain = stbp_core(rtab, 2, rprior, rsynd, method, I, msf, early_stop=False)
        torch.cuda.synchronize()
        worst["K2"] = max(worst["K2"], _same(f"K2 {rst.name} {method} [{_plan_tag(plan)}]", rst,
                                             rsynd, kern, plain))
    # K6: the single-shot device step on (H|I) (one shot would fit a resident block: the
    # streamed route, K6's rule), and the resident route "wide" at the random matrix
    ssynd = ss.syndromes(shots, WIDE_P, seed=43)
    sprior = ss.prior(WIDE_P)
    rflat = FlatSetup(rand_H, dev, "random 60x300")
    fsynd = rflat.syndromes(shots, 3e-3, seed=45)
    fprior = rflat.prior(3e-3)
    for fs, synd_k6, prior_k6, route in ((ss, ssynd, sprior, "streamed"),
                                         (rflat, fsynd, fprior, "resident")):
        plan = k6.launch_plan(fs.tables, shots, dev)
        check(plan.wide and plan.route == route, f"K6 {fs.name}: {plan.label}")
        for method, msf in (("ms", ALPHA), ("ps", 0.0)):
            kern = k6.bp_fixed(fs.tables, prior_k6, synd_k6, method, I, msf, plan=plan)
            plain = bp_core(fs.tables, prior_k6, synd_k6, method, I, msf, early_stop=False)
            torch.cuda.synchronize()
            worst["K6"] = max(worst["K6"], _same(f"K6 {fs.name} {method} [{_plan_tag(plan)}]",
                                                 fs, synd_k6, kern, plain))
    # K1 (route wide) at the single-shot host redecode's (H|I), ragged
    _k1_case(ss, ssynd[:, :WIDE_RAGGED].contiguous(), sprior, "ms", ALPHA, True, I)
    # K4 at the detector model's 53-slot checks
    dsynd = dem.draw(shots, seed=44)
    for D in (2, 4):
        for method, msf in (("ms", ALPHA), ("ps", 0.0)):
            dec = k4.ShardedBSRDecoder.from_check_matrix(
                dem.H, D, channel_probs=dem.priors, max_iter=I, bp_method=method,
                ms_scaling_factor=msf, device=dev)
            kern = _k4(dec, dsynd)
            plain = _k4(dec, dsynd, k4.bsr_shard_iter_plain)
            torch.cuda.synchronize()
            worst["K4"] = max(worst["K4"], _same(f"K4 {dem.name} D={D} {method}", dem, dsynd,
                                                 kern, plain))
    routes = {name: _routes_since(kern, before[name]) for name, kern in KERNELS.items()}
    log(f"  routes of this phase: {routes}")
    check(routes["K3"].get("wide", 0) > 0 and routes["K4"].get("wide", 0) > 0,
          "K3 and K4 ran route wide")
    check(all(routes["K2"].get(r, 0) > 0 for r in ("resident_wide", "streamed_wide"))
          and all(routes["K6"].get(r, 0) > 0 for r in ("resident_wide", "streamed_wide")),
          "K2 and K6 ran route wide on the resident and the streamed route")
    if timings:   # min-sum, one run each
        args = (tables, R, prior, synd, "ms", I, ALPHA)
        _time_pair(t, "K3_wide_dense", lambda: k3.stbsr_decode(*args, False),
                   lambda: k3.stbsr_decode(*args, False, iterate=k3._stbsr_iter_plain))
        _time_pair(t, "K2_wide_dense_streamed", lambda: k2.stbp_fixed(*args),
                   lambda: stbp_core(*args, early_stop=False))
        rargs = (rtab, 2, rprior, rsynd, "ms", I, ALPHA)
        _time_pair(t, "K2_wide_random_resident", lambda: k2.stbp_fixed(*rargs),
                   lambda: stbp_core(*rargs, early_stop=False))
        sargs = (ss.tables, sprior, ssynd, "ms", I, ALPHA)
        _time_pair(t, "K6_wide_ss_streamed", lambda: k6.bp_fixed(*sargs),
                   lambda: bp_core(*sargs, early_stop=False))
        fargs = (rflat.tables, fprior, fsynd, "ms", I, ALPHA)
        _time_pair(t, "K6_wide_random_resident", lambda: k6.bp_fixed(*fargs),
                   lambda: bp_core(*fargs, early_stop=False))
        for D in (2, 4):   # per decode iteration, all shards: phase 18's slope (2 -> 6)
            dec = k4.ShardedBSRDecoder.from_check_matrix(
                dem.H, D, channel_probs=dem.priors, max_iter=I, bp_method="ms",
                ms_scaling_factor=ALPHA, device=dev)
            key = f"K4_wide_dem_D{D}"
            for k, it in ((key, k4.bsr_shard_iter), (f"{key}_plain", k4.bsr_shard_iter_plain)):
                t[k] = 1e3 * shard_capacity.per_iter_slope(
                    lambda s, n, it=it: dec.decode_tensors(s, max_iter=n, iterate=it), dem.H,
                    dev, shots, 2 * DEM_P, lo=2, hi=6, nrep=1)
            log(f"  {key}: {t[key]:.4f} ms per iteration, plain {t[key + '_plain']:.4f}")
        # the least time of the same work (the kernel_bounds formulas)
        st_rows, st_cols = st.H.shape
        bounds["K3_wide_dense"] = _bound(
            I * (_st_io(st_rows, st_cols, tables, shots) + 2 * 2 * st.H.nnz * shots),
            OPS_FLOAT * st.H.nnz * shots * I)
        bounds["K2_wide_dense_streamed"] = _bound(_st_io(st_rows, st_cols, tables, shots),
                                                  OPS_FLOAT * st.H.nnz * shots * I)
        bounds["K2_wide_random_resident"] = _bound(_st_io(*rst.H.shape, rtab, shots),
                                                   OPS_FLOAT * rst.H.nnz * shots * I)
        bounds["K6_wide_ss_streamed"] = _bound(_flat_io(ss.tables, shots),
                                               OPS_FLOAT * ss.H.nnz * shots * I)
        bounds["K6_wide_random_resident"] = _bound(_flat_io(rflat.tables, shots),
                                                   OPS_FLOAT * rflat.H.nnz * shots * I)
        for D in (2, 4):
            v_pad = k4.ShardedBSR.from_check_matrix(dem.H, D).v_pad
            bounds[f"K4_wide_dem_D{D}"] = _bound(
                D * 2 * 4 * v_pad * shots + 2 * 2 * dem.H.nnz * shots + dem.H.shape[0] * shots
                + 2 * 4 * dem.H.nnz, OPS_FLOAT * dem.H.nnz * shots)
        shapes = {"K3_wide_dense": f"dense HGP x{R} rounds (34-slot checks), {shots} x {I}",
                  "K2_wide_dense_streamed": f"dense HGP x{R} rounds, {shots} x {I}, streamed",
                  "K2_wide_random_resident": f"random 60x300 (33-40 slots) x2 rounds, {shots} x "
                                             f"{I}, resident",
                  "K6_wide_ss_streamed": f"dense HGP (H|I) (33 slots), {shots} x {I}, streamed",
                  "K6_wide_random_resident": f"random 60x300 (33-40 slots), {shots} x {I}, "
                                             f"resident",
                  "K4_wide_dem_D2": f"DEM 216x1518 (Dc 53), D=2, {shots} shots, per iteration",
                  "K4_wide_dem_D4": f"DEM 216x1518 (Dc 53), D=4, {shots} shots, per iteration"}
    return worst, t, bounds, shapes


def phase_wide_sweeps(code, dem: "PriorSetup", dev: torch.device, shots: int) -> dict:
    """One p_sweep point per pipeline mode on the dense HGP, and a
    check-partition decode of the detector model: the entry points run end
    to end on route wide (each run counted from 0)."""
    log(f"== phase 24 (cont.): p_sweep, one point per pipeline mode on the dense HGP, "
        f"{shots} shots, p = {WIDE_P:g}, min-sum {WIDE_ITERS} iterations, OSD-0")
    by_run = {}
    for mode in ("bposd", "bposd_single_shot", "bposd_hybrid"):
        reset_counts()
        routes0 = {name: dict(kern.routes) for name, kern in KERNELS.items()}
        rec = p_sweep(
            samples=shots, p_values=np.array([WIDE_P]), noise_model=depolarizing_noise,
            noise_model_args=lambda p: {"p": p, "pm": p},
            meas_prior=lambda p, xs, zs: 2 / 3 * p, data_prior=lambda p, xs, zs: 2 / 3 * p,
            seed=3, pipeline={"mesh_devices": 1, "shots_per_device": shots}, device=dev,
            code=code, rounds=WIDE_ROUNDS, decoder_mode=mode,
            bp_osd_options=dict(WIDE_OPTIONS))[0]
        torch.cuda.synchronize()
        routes = {name: _routes_since(kern, routes0[name]) for name, kern in KERNELS.items()}
        launches = launch_counts()
        log(f"  {mode}: failures {rec['failures']}, shots {rec['samples']}, "
            f"{rec['samples'] / rec['walltime']:.0f} shots/s; routes {routes}")
        check(rec["samples"] == shots and rec["failures"] < shots // 2,
              f"{mode} on the dense HGP: one result per shot, most shots decoded")
        want = {"bposd": ("K3", "wide"), "bposd_single_shot": ("K6", "streamed_wide"),
                "bposd_hybrid": ("K2", "streamed_wide")}[mode]
        check(routes[want[0]].get(want[1], 0) > 0, f"{mode}: {want[0]} ran route {want[1]}")
        by_run[f"dense_hgp_{mode}"] = launches
    # the model axis's entry point at 53-slot checks: ShardedBSRDecoder.decode_batch, D = 4
    reset_counts()
    synd = dem.draw(4 * shots, seed=45)
    dec = k4.ShardedBSRDecoder.from_check_matrix(dem.H, 4, channel_probs=dem.priors,
                                                 max_iter=WIDE_ITERS, bp_method="ms",
                                                 ms_scaling_factor=ALPHA, device=dev)
    hard, _post, conv = dec.decode_batch(synd.T.cpu().numpy())
    torch.cuda.synchronize()
    wide = k4.KERNEL.routes.get("wide", 0)
    launches = launch_counts()
    ok = ((hard.astype(np.int64) @ dem.H.T) % 2 == synd.T.cpu().numpy()).all(axis=1)
    log(f"  check-partition decode of {dem.name}, D=4, {4 * shots} shots: conv rate "
        f"{float(conv.mean()):.4f}, K4 launches {launches['K4']} ({wide} on route wide)")
    check(launches["K4"] == 4 * WIDE_ITERS and wide == launches["K4"],
          "every K4 call of the detector model's check-partition decode took route wide")
    check(bool(ok[conv].all()), "every converged shot satisfies its syndrome")
    by_run["dem_check_partition"] = launches
    return by_run


# ---------------------------------------------------------------------------
# The streamed routes of K2 and K6 on the codes past shared memory (phase 38)
# ---------------------------------------------------------------------------

SELECT_ROWS = ROOT / "artifacts" / "select_h100.jsonl"
# The streamed shapes this phase times, each with the row of SELECT_ROWS (its
# line number) that timed the same shape on an H100 before the route ran as
# device-memory grids: K2 at the cyclic code x4, 2,048 x 48 (row 24); K6 at
# the n = 40,000 HGP, 685 x 48 (row 220).
STREAMED_ROWS = {"K2_streamed_cyclic_x4": 24, "K6_streamed_n40000": 220}
STREAMED_P_HYBRID, STREAMED_P_SS = 1e-4, 5e-4
STREAMED_SHOTS = 2048


def _select_row(line: int) -> dict:
    with SELECT_ROWS.open() as f:
        return json.loads(f.read().splitlines()[line - 1])


def streamed_setups():
    """The slice's codes (host work, built in a thread at the start): the
    cyclic lifted product n = 4,862 with its logicals (phases 17, 25, 35)
    and HGP n = 15,625 (``biregular_hgp(100, 3, 4)``) with its logicals,
    the n = 40,000 HGP of ``bench_select``'s rows (seed 11)."""
    from exp_ldpc_tpu_torch.experiments import bench_two_tier as btt

    return (btt.build_code(), biregular_hgp(100, 3, 4, seed=0, compute_logicals=True),
            biregular_hgp(160, 3, 4, seed=11).checks.z)


def phase_streamed(dev: torch.device, setups) -> tuple:
    """K2 and K6 on their streamed route (the device-memory grids): held bit
    for bit to their plain versions at the slice's shapes, timed beside the
    rows measured before the redesign and both bounds, then the slice's path
    through its entry points.  Returns (worst error by kernel, launches by
    run, times, bounds)."""
    cyc, hgp15k, H40k = setups.result()
    log(f"== phase 38: the streamed routes of K2 and K6: parity at the cyclic code x4 "
        f"(2,048, 685, 77, 1 shots), the n = 40,000 HGP (685, 77, 1), the dense HGP's route "
        f"wide (77); timings; the hybrid p_sweep on the cyclic code x4 and the single-shot "
        f"flat stage on HGP n = 15,625 (H|I), {STREAMED_SHOTS} shots x {MAX_ITER}")
    worst = {"K2": 0.0, "K6": 0.0}
    t, bounds = {}, {}
    Hc = cyc.checks.z
    ctab = tanner_tables(TannerELL.from_check_matrix(Hc), dev)
    cst = Checks(SpacetimeCode(Hc, ROUNDS).spacetime_check_matrix, dev, "cyclic LP n=4862 x4")
    cprior = cst.prior(2 / 3 * 2e-4)
    csyn = cst.device_syndromes(STREAMED_SHOTS, 2e-4, seed=61)
    big = FlatSetup(H40k, dev, "HGP n=40000")
    bprior = big.prior(5e-4)
    bsyn = big.device_syndromes(S_REDECODE, 5e-4, seed=62)
    dense = dense_hgp().checks.z
    dtab = tanner_tables(TannerELL.from_check_matrix(dense), dev)
    dst = Checks(SpacetimeCode(dense, WIDE_ROUNDS).spacetime_check_matrix, dev,
                 f"dense HGP x{WIDE_ROUNDS}")
    dss = FlatSetup(SpacetimeCodeSingleShot(dense).spacetime_check_matrix, dev,
                    "dense HGP (H|I)")
    before = {name: dict(k.routes) for name, k in (("K2", k2.KERNEL), ("K6", k6.KERNEL))}

    def k2_case(chk, tab, R, prior, synd, method, msf, iters):
        plan = k2.launch_plan(tab, R, synd.shape[1], dev)
        check(plan.route == "streamed", f"K2 {chk.name} S={synd.shape[1]}: {plan.label}")
        kern = k2.stbp_fixed(tab, R, prior, synd, method, iters, msf)
        plain = stbp_core(tab, R, prior, synd, method, iters, msf, early_stop=False)
        torch.cuda.synchronize()
        worst["K2"] = max(worst["K2"], _same(
            f"K2 {chk.name} S={synd.shape[1]} {method} alpha={msf} [{_plan_tag(plan)}]", chk,
            synd, kern, plain))

    def k6_case(fs, prior, synd, method, msf, iters, route="auto"):
        plan = k6.launch_plan(fs.tables, synd.shape[1], dev, route=route)
        check(plan.route == "streamed", f"K6 {fs.name} S={synd.shape[1]}: {plan.label}")
        kern = k6.bp_fixed(fs.tables, prior, synd, method, iters, msf, plan=plan)
        plain = bp_core(fs.tables, prior, synd, method, iters, msf, early_stop=False)
        torch.cuda.synchronize()
        worst["K6"] = max(worst["K6"], _same(
            f"K6 {fs.name} S={synd.shape[1]} {method} alpha={msf} [{_plan_tag(plan)}]", fs,
            synd, kern, plain))

    k2_case(cst, ctab, ROUNDS, cprior, csyn, "ms", ALPHA, MAX_ITER)
    for S, method, msf in ((S_REDECODE, "ps", 0.0), (S_SMALL, "ms", 0.0), (1, "ps", 0.0)):
        k2_case(cst, ctab, ROUNDS, cprior, csyn[:, :S].contiguous(), method, msf, MAX_ITER)
    for S, method, msf in ((S_REDECODE, "ms", ALPHA), (S_SMALL, "ps", 0.0), (1, "ms", 0.0)):
        k6_case(big, bprior, bsyn[:, :S].contiguous(), method, msf, MAX_ITER)
    # route wide: the dense HGP's 34-slot spacetime checks and 33-slot (H|I), ragged
    wsyn = dst.syndromes(S_SMALL, WIDE_P, seed=63)
    ssyn = dss.syndromes(S_SMALL, WIDE_P, seed=64)
    for method, msf in (("ms", ALPHA), ("ps", 0.0)):
        k2_case(dst, dtab, WIDE_ROUNDS, dst.prior(2 / 3 * WIDE_P), wsyn, method, msf,
                WIDE_ITERS)
        k6_case(dss, dss.prior(WIDE_P), ssyn, method, msf, WIDE_ITERS, route="streamed")
    routes = {name: _routes_since(k, before[name])
              for name, k in (("K2", k2.KERNEL), ("K6", k6.KERNEL))}
    check(all(routes[k].get(r, 0) > 0 for k in ("K2", "K6") for r in ("streamed",
                                                                      "streamed_wide")),
          f"K2 and K6 ran the streamed route and its route wide: {routes}")
    # timings (CUDA events, median of 3 distinct batches; plain once) beside the row
    # measured before the redesign, the on-chip bound and the device-memory bound
    cs = [cst.device_syndromes(STREAMED_SHOTS, 2e-4, seed=70 + i) for i in range(4)]
    bs = [big.device_syndromes(S_REDECODE, 5e-4, seed=75 + i) for i in range(4)]
    cargs = (ctab, ROUNDS, cprior)
    cases = {
        "K2_streamed_cyclic_x4": (
            lambda s: k2.stbp_fixed(*cargs, s, "ms", MAX_ITER, ALPHA),
            lambda s: stbp_core(*cargs, s, "ms", MAX_ITER, ALPHA, early_stop=False), cs,
            _st_io(*cst.H.shape, ctab, STREAMED_SHOTS), cst.H.shape[0], ctab, cst.H.nnz,
            STREAMED_SHOTS, f"cyclic LP n=4862 x{ROUNDS}, {STREAMED_SHOTS} x {MAX_ITER}"),
        "K6_streamed_n40000": (
            lambda s: k6.bp_fixed(big.tables, bprior, s, "ms", MAX_ITER, ALPHA),
            lambda s: bp_core(big.tables, bprior, s, "ms", MAX_ITER, ALPHA, early_stop=False),
            bs, _flat_io(big.tables, S_REDECODE), big.H.shape[0], big.tables, big.H.nnz,
            S_REDECODE,
            f"HGP n=40000, {S_REDECODE} x {MAX_ITER}")}
    for key, (kern, plain, synds, io, rows, tab, nnz, shots, shape) in cases.items():
        kern(synds[3])
        t[key] = _median_ms(kern, synds[:3])
        t[f"{key}_plain"] = _timed(lambda: plain(synds[0]))[1]
        row = _select_row(STREAMED_ROWS[key])
        check(row["shots"] == shots and row["iters"] == MAX_ITER and "streamed" in row["route"],
              f"{SELECT_ROWS.name} row {STREAMED_ROWS[key]} times the same shape")
        bounds[key] = {"on_chip": _bound(io, OPS_FLOAT * nnz * shots * MAX_ITER),
                       "device_memory": streamed_bound(io, rows, tab, nnz, shots, MAX_ITER),
                       "shape": shape}
        b0, b1 = bounds[key]["on_chip"], bounds[key]["device_memory"]
        log(f"  {key} ({shape}): {t[key]:.3f} ms (before the redesign, not measured in this "
            f"run: {row['ms']:.2f} ms, {SELECT_ROWS.name} row {STREAMED_ROWS[key]}, "
            f"{row['nvidia_smi']}); plain "
            f"{t[key + '_plain']:.2f} ms; bound on chip {b0['bound_ms']:.4f} ms "
            f"({b0['bound_by']}), through device memory {b1['bound_ms']:.4f} ms "
            f"({b1['bound_by']})")
    # the slice's path: the hybrid p_sweep point on the cyclic code x4 (K2 streamed in the
    # spacetime stage, K6 in the final-round flat stage, K3 and K1 in the host redecode)
    by_run = {}
    reset_counts()
    routes0 = {name: dict(kern.routes) for name, kern in KERNELS.items()}
    rec = p_sweep(
        samples=STREAMED_SHOTS, p_values=np.array([STREAMED_P_HYBRID]),
        noise_model=depolarizing_noise, noise_model_args=lambda p: {"p": p, "pm": p},
        meas_prior=lambda p, xs, zs: 2 / 3 * p, data_prior=lambda p, xs, zs: 2 / 3 * p,
        seed=11, pipeline={"mesh_devices": 1, "shots_per_device": STREAMED_SHOTS}, device=dev,
        code=cyc, rounds=ROUNDS, decoder_mode="bposd_hybrid",
        bp_osd_options=dict(max_iter=MAX_ITER, bp_method="ms", ms_scaling_factor=ALPHA,
                            osd_method="osd0", osd_order=0))[0]
    torch.cuda.synchronize()
    routes = {name: _routes_since(kern, routes0[name]) for name, kern in KERNELS.items()}
    launches = launch_counts()
    t["hybrid_cyclic_shots_per_s"] = rec["samples"] / rec["walltime"]
    log(f"  bposd_hybrid, cyclic LP n=4862 x{ROUNDS}, p={STREAMED_P_HYBRID:g}: failures "
        f"{rec['failures']} of {rec['samples']}, {t['hybrid_cyclic_shots_per_s']:.0f} shots/s; "
        f"routes {routes}")
    check(rec["samples"] == STREAMED_SHOTS and rec["failures"] < rec["samples"] // 2,
          "hybrid at the cyclic code: one result per shot, most shots decoded")
    check(routes["K2"].get("streamed", 0) > 0 and launches["K6"] > 0,
          "hybrid at the cyclic code: K2 streamed in the spacetime stage, K6 in the flat stage")
    by_run["hybrid_cyclic_x4"] = launches
    # the single-shot flat stages on HGP n = 15,625 ((H|I) and H: 247 KB a shot each with
    # the fixed bytes, K6 streamed), the device step of two batches through the pipeline
    # (no host OSD)
    pipe = StorageDecodePipeline(
        code=hgp15k, rounds=ROUNDS, noise_model=depolarizing_noise(STREAMED_P_SS, STREAMED_P_SS),
        data_prior=2 / 3 * STREAMED_P_SS, meas_prior=2 / 3 * STREAMED_P_SS,
        shots_per_device=STREAMED_SHOTS,
        max_iter=MAX_ITER, bp_method="ms", ms_scaling_factor=ALPHA, mode="bposd_single_shot",
        device=dev)
    check(k6.launch_plan(pipe._tables_ss, STREAMED_SHOTS, dev).route == "streamed",
          f"HGP n=15,625 (H|I): {k6.resident_bytes(pipe._tables_ss)[0]} B a shot, streamed")
    gens = []
    for i in range(3):
        g = torch.Generator(device=dev)
        g.manual_seed(500 + i)
        gens.append(g)
    pipe.run(gens[2])   # warm-up
    reset_counts()
    routes0 = dict(k6.KERNEL.routes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fails = unconv = shots = 0
    for g in gens[:2]:
        f, n, u = pipe.run(g)
        fails, shots, unconv = fails + f, shots + n, unconv + u
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    routes = _routes_since(k6.KERNEL, routes0)
    launches = launch_counts()
    t["single_shot_hgp15625_shots_per_s"] = shots / wall
    log(f"  bposd_single_shot device step, HGP n=15,625 x{ROUNDS}, p={STREAMED_P_SS:g}, {shots} "
        f"shots: "
        f"failures {fails}, BP-unconverged {unconv}, {shots / wall:.0f} shots/s; K6 routes "
        f"{routes}")
    check(routes.get("streamed", 0) == 2 * (ROUNDS + 1) and fails < shots // 2,
          "single-shot at HGP n=15,625: every flat stage on K6 streamed (one shot of (H|I) or "
          "of H does not fit shared memory), most shots decoded")
    by_run["single_shot_hgp15625"] = launches
    return worst, by_run, t, bounds


TT_REF_FAILURES, TT_REF_UNCONV, TT_REF_SHOTS = 1081, 1131, 8192   # artifacts/two_tier_v5e.jsonl


def phase_two_tier(su: Setup, dev: torch.device) -> tuple:
    """bench_two_tier's regime on the card; returns (launches by run, times, shots/s)."""
    from exp_ldpc_tpu_torch.experiments import bench_two_tier as btt

    log("== phase 25: two-tier decode: bench_two_tier's regime (cyclic LP n=4,862, 4 rounds, "
        "p=2e-4, 4 x 2,048 shots x 48, tier 1 = 8, cap 512), fixed and two-tier on the same "
        "seeds")
    code = btt.build_code()
    args = btt.parse_args(["--device", str(dev)])
    args.device = dev
    pipes = {v: btt.build(code, v, args) for v in btt.VARIANTS}
    check(spacetime_choice(pipes["fixed"]._tables, args.rounds, dev, early_stop=False) == "K3",
          "the selection takes K3 at the cyclic code x4 (one shot of K2 does not fit shared "
          "memory)")
    reset_counts()
    rows = btt.compare(pipes, args)
    launches = launch_counts()
    fixed, two = rows[0], rows[1]
    check(fixed["kernel"] == two["kernel"] == "stbsr", "both variants run K3")
    for key in ("failures", "bp_unconverged"):
        a, b = fixed[key], two[key]
        check(abs(a - b) <= max(3, 0.1 * max(a, b)),
              f"{key}: fixed {a} and two-tier {b} agree within max(3, 10%)")
    for row in (fixed, two):
        check(_ler_gap(row["failures"], row["shots"], TT_REF_FAILURES / TT_REF_SHOTS,
                       TT_REF_SHOTS, f"{row['mode']} failures"),
              f"{row['mode']}: failures within 4 sigma of the artifact's 1,081 / 8,192")
    log(f"  shots/s: fixed {fixed['shots_per_s']:.0f}, two-tier {two['shots_per_s']:.0f} "
        f"(ms per batch {fixed['ms_per_batch']:.2f} / {two['ms_per_batch']:.2f})")
    # the device step alone, and K3 on the compacted stage-2 decode
    pipe = pipes["two_tier"]
    synds = []
    for seed in range(6):
        gen = torch.Generator(device=dev)
        gen.manual_seed(200 + seed)
        synds.append(pipe.spacetime_syndromes(*pipe._split_record(
            pipe._sample(gen, pipe._noise_args))))
    t = {"two_tier_fixed_step": _median_ms(pipe.decode_spacetime, synds[:5]),
         "two_tier_step": _median_ms(pipe.decode_two_tier, synds[:5])}
    log(f"  device step (spacetime decode of one batch, median of 5): fixed "
        f"{t['two_tier_fixed_step']:.2f} ms, two-tier {t['two_tier_step']:.2f} ms")
    _h, conv = pipe.decode_spacetime(synds[5], pipe.tier1_iters)
    order = torch.argsort(conv.to(torch.int32), stable=True)[: pipe.tier2_cap]
    s2 = synds[5][:, order].contiguous()
    st = Checks(SpacetimeCode(code.checks.z, args.rounds).spacetime_check_matrix, dev,
                "cyclic LP n=4862 x4")
    # the bounds of both device steps: the fixed decode (every shot, max_iter), and the
    # two-tier one, its two decodes in turn (every shot at tier 1, the cap at max_iter)
    S = synds[0].shape[1]
    b_fixed = _k3_bound(st, pipe._tables, S, S * args.max_iter)
    b_tiers = [_k3_bound(st, pipe._tables, S, S * pipe.tier1_iters),
               _k3_bound(st, pipe._tables, pipe.tier2_cap, pipe.tier2_cap * args.max_iter)]
    t["two_tier_fixed_step_bound"] = b_fixed
    t["two_tier_step_bound"] = {
        "bound_ms": sum(b["bound_ms"] for b in b_tiers),
        "bound_by": max(b_tiers, key=lambda b: b["bound_ms"])["bound_by"]}
    log(f"  bounds: fixed step {b_fixed['bound_ms']:.3f} ms ({b_fixed['bound_by']}; {S} x "
        f"{args.max_iter}), two-tier step {t['two_tier_step_bound']['bound_ms']:.3f} ms "
        f"({S} x {pipe.tier1_iters}, then {pipe.tier2_cap} x {args.max_iter})")
    kern = k3.stbsr_decode(pipe._tables, args.rounds, pipe._prior, s2, "ms", args.max_iter,
                           ALPHA, False)
    plain = k3.stbsr_decode(pipe._tables, args.rounds, pipe._prior, s2, "ms", args.max_iter,
                            ALPHA, False, iterate=k3._stbsr_iter_plain)
    torch.cuda.synchronize()
    err = _same(f"K3 stage 2, {s2.shape[1]} compacted shots ({int((~conv).sum())} unconverged "
                f"after stage 1)", st, s2, kern, plain)
    check(bool(torch.equal(kern[1], plain[1])), "stage 2: K3's posteriors bit-identical to plain")
    # the flagship bposd point with tier1_iters = 8, on phase 6's anchor
    reset_counts()
    rec = p_sweep(
        samples=32768, p_values=np.array([P_HI]), noise_model=depolarizing_noise,
        noise_model_args=lambda p: {"p": p, "pm": p},
        meas_prior=lambda p, xs, zs: 2 / 3 * p, data_prior=lambda p, xs, zs: 2 / 3 * p,
        seed=9, pipeline={"mesh_devices": 1, "shots_per_device": 16384}, device=dev,
        code=su.code, rounds=ROUNDS, decoder_mode="bposd",
        bp_osd_options=dict(OPTIONS, tier1_iters=8))[0]
    torch.cuda.synchronize()
    flagship = launch_counts()
    log(f"  HGP-225 bposd, tier1_iters=8: failures {rec['failures']} of {rec['samples']}, "
        f"{rec['samples'] / rec['walltime']:.0f} shots/s, launches {flagship}")
    check(ler_within(rec["failures"], rec["samples"], P_HI),
          f"two-tier p={P_HI:.6g}: LER within 4 sigma of the artifact")
    check(flagship["K2"] >= 4 and flagship["K3"] > 0,
          "two-tier flagship: K2 (the selection's fixed-iteration kernel at HGP-225 x4) twice "
          "per batch, K3 in the host redecode")
    speed = {"fixed": fixed["shots_per_s"], "two_tier": two["shots_per_s"],
             "flagship_two_tier": rec["samples"] / rec["walltime"]}
    return {"two_tier_bench": launches, "two_tier_flagship": flagship}, t, speed, err


RS_ROUNDS, RS_SHOTS, RS_ITERS, RS_P = 7, 2048, 24, 3e-3


def _rounds_case():
    """HGP-225's Z checks over 7 rounds (8 blocks, 4 a rank), 2,048 shots."""
    H = biregular_hgp(12, 3, 4, seed=0).checks.z
    Hst = SpacetimeCode(H, RS_ROUNDS).spacetime_check_matrix.tocsr().astype(np.int64)
    rng = np.random.default_rng(61)
    err = (rng.random((RS_SHOTS, Hst.shape[1])) < RS_P).astype(np.int64)
    return H, Hst, ((Hst @ err.T) % 2).T.astype(np.uint8)


def _rounds_rank(rank: int, world: int) -> dict:
    """One rank of phase 26 (runs in its own process): round blocks split
    over a model group of 2 on the one card, gloo."""
    from exp_ldpc_tpu_torch.parallel.rounds_shard import RoundsShardedSpacetimeBP

    mesh = make_mesh(model_parallel=2, device="cuda")
    H, _Hst, synd = _rounds_case()
    dec = RoundsShardedSpacetimeBP.from_check_matrix(
        H, RS_ROUNDS, mesh, error_rate=RS_P, max_iter=RS_ITERS, bp_method="ms",
        ms_scaling_factor=ALPHA)
    dec.decode_batch(synd[:64])   # warm-up
    t0 = time.perf_counter()
    hard, _post, conv, _iters = dec.decode_batch(synd)
    return {"hard": hard, "conv": conv, "secs": time.perf_counter() - t0,
            "device": str(mesh.device), "coords": mesh.coords}


def rounds_world():
    """Phase 26's two ranks: (their results, seconds from start to join)."""
    t0 = time.perf_counter()
    ranks = run_world(_rounds_rank, 2, backend="gloo", timeout=300, threads=None)
    return ranks, time.perf_counter() - t0


def phase_rounds_shard(dev: torch.device, world) -> None:
    log(f"== phase 26: rounds axis: two gloo ranks on the card, HGP-225 x{RS_ROUNDS} rounds "
        f"(4 blocks a rank), {RS_SHOTS} shots x {RS_ITERS}, halo rows staged through the host")
    ranks, secs = world.result()
    H, Hst, synd = _rounds_case()
    tables = tanner_tables(TannerELL.from_check_matrix(H), dev)
    prior = torch.as_tensor(priors_to_llr(np.full(Hst.shape[1], RS_P))).to(dev)
    rh, _rp, rc, _ri = stbp_core(tables, RS_ROUNDS, prior, torch.as_tensor(synd.T.copy()).to(dev),
                                 "ms", RS_ITERS, ALPHA, early_stop=False)
    rh, rc = rh.T.cpu().numpy(), rc.cpu().numpy()
    log(f"  ranks on {[r['device'] for r in ranks]}, coords {[r['coords'] for r in ranks]}; "
        f"{secs:.1f} s from start to join (beside the parity phases), sharded decode "
        f"{max(r['secs'] for r in ranks):.2f} s")
    for k, r in enumerate(ranks):
        conv = r["conv"]
        differ = int((r["hard"][conv] != rh[conv]).any(axis=1).sum())
        check(differ <= 0.001 * max(int(conv.sum()), 1),
              f"rank {k}: sharded and unsharded decisions differ on {differ} of "
              f"{int(conv.sum())} converged shots (at most 0.1%); conv agree "
              f"{float((conv == rc).mean()):.4f}")
        ok = ((r["hard"].astype(np.int64) @ Hst.T) % 2 == synd).all(axis=1)
        check(bool(ok[conv].all()), f"rank {k}: every converged shot satisfies its syndrome")


def phase_profiler(su: Setup, dev: torch.device) -> dict:
    """A ``profiler_trace`` of one bposd pipeline batch (K3)."""
    from exp_ldpc_tpu_torch.experiments.profile_batch import summarize
    from exp_ldpc_tpu_torch.utils.observability import profiler_trace

    log("== phase 27: profiler_trace of one bposd pipeline batch (HGP-225, 4,096 shots, K3 by "
        "bp_backend='stbsr'; the device step, no host OSD)")
    p = P_HI
    pipe = StorageDecodePipeline(
        code=su.code, rounds=ROUNDS, noise_model=depolarizing_noise(p, p),
        data_prior=2 / 3 * p, meas_prior=2 / 3 * p, shots_per_device=4096, max_iter=MAX_ITER,
        bp_method="ms", ms_scaling_factor=ALPHA, bp_backend="stbsr", device=dev)
    gens = []
    for seed in (71, 72):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        gens.append(g)
    pipe.run(gens[0])
    out = ROOT / "build" / "exp_ldpc_tpu_torch" / "chip_smoke_trace"
    with profiler_trace(str(out)) as prof:
        pipe.run(gens[1])
    check(prof is not None, "the profiler started")
    trace = json.loads((out / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"] if e.get("cat") == "kernel"}
    summary = summarize(trace, MAX_ITER)
    log(f"  {len(trace['traceEvents'])} trace events, {len(names)} kernel names; busy "
        f"{summary['busy_ms']:.2f} ms, K3 grids {summary['k3_launches']}")
    check(any("stbsr_check_kernel" in n for n in names),
          "the trace names K3's kernels (stbsr_check_kernel)")
    return {"busy_ms": summary["busy_ms"], "k3_grids": summary["k3_launches"]}


# ---------------------------------------------------------------------------
# The counterparts of scripts/: validate_ler, bench_gross, validate_dem,
# demo_sliding_window, bench_osd_host, bench_spacetime, bench_scaling
# ---------------------------------------------------------------------------

LER_SHOTS = 16384          # per gated validate_ler point (the artifacts' 401,408-1,000,000 cut)
CROSS_SHOTS = 2000         # host shots of validate_ler's cross-check
# (noise, decode, p, artifact, its samples, cross-check); every run's spacetime stage is K2
LER_CASES = (
    ("pheno", "bp", 0.0034822022531844966, "ler_hgp225_v5e.jsonl", 1000000, False),
    ("circuit", "bp", 0.000522330337977674, "ler_hgp225_circuit_v5e.jsonl", 1000000, False),
    ("circuit", "bposd", 0.0002273574849765597, "ler_hgp225_bposd_circuit_v5e.jsonl", 401408,
     True),
)
# The Z logical representatives that scored ler_hgp225_v5e.jsonl and
# ler_hgp225_circuit_v5e.jsonl (both "--decode bp") are those of
# artifacts/hgp225.qecc: those rows were taken before the homological
# logical extraction was rewritten, and biregular_hgp(12, 3, 4, seed=0) has
# had other representatives since (the same checks).  A BP-unconverged shot
# keeps a correction that leaves a syndrome, and its logical outcome depends
# on the representatives; a syndrome-free shot's does not, so the bposd rows
# hold with either set.
GROSS_GATES = (0.002924017738212867, 0.005)   # the rows of gross_memory_12r_v5e.jsonl gated
DEM_GATE_P = 0.0007917047464637365            # ler_hgp225_dem_circuit_v5e.jsonl: 69 / 8,192
DEM_SAMPLES, DEM_BATCH = 8192, 2048           # the artifact's sample count, uncut


def _artifact_row(name: str, p: float, key: str = "p_ph", **match) -> dict:
    """The row of ``artifacts/<name>`` at ``p`` (relative 1e-9) matching ``match``."""
    for line in (ROOT / "artifacts" / name).read_text().splitlines():
        rec = json.loads(line)
        if key in rec and abs(rec[key] - p) <= 1e-9 * p and all(
                rec.get(k) == v for k, v in match.items()):
            return rec
    raise KeyError((name, p, match))


def _gate(fails: int, shots: int, name: str, p: float, label: str, key: str = "p_ph",
          **match) -> None:
    art = _artifact_row(name, p, key, **match)
    n_ref = art.get("samples", art.get("shots"))
    check(_ler_gap(fails, shots, art["failures"] / n_ref, n_ref, label),
          f"{label}: LER within 4 combined sigma of {name}'s {art['failures']} / {n_ref}")


def bp_artifact_code(code):
    """``code`` (HGP-225) with the Z logicals of :data:`CODE_FILE`, after
    checking that they are Z logicals spanning today's modulo the Z checks."""
    with CODE_FILE.open() as f:
        Lz = np.asarray(read_quantum_code(f).logicals.z, dtype=code.logicals.z.dtype)
    Hx, Hz = code.checks.x.toarray(), code.checks.z.toarray()
    now = np.asarray(code.logicals.z)
    r = gf2_rank(Hz)
    if ((Hx.astype(np.int64) @ Lz.T) % 2).any() or gf2_rank(np.vstack([Hz, Lz])) != r + len(Lz) \
            or gf2_rank(np.vstack([Hz, Lz, now])) != r + len(Lz):
        raise AssertionError(f"{CODE_FILE.name}'s Z logicals are not Z logicals of this code")
    return QuantumCode(code.checks, QuantumCodeLogicals(np.array(code.logicals.x), Lz))


def _run_counted(fn, *a):
    """fn(*a) with every launch count reset before it; (its result, the launches)."""
    reset_counts()
    out = fn(*a)
    torch.cuda.synchronize()
    return out, launch_counts()


def phase_validate_ler(code) -> dict:
    """validate_ler's three gated points and the cross-check (one run each).
    A ``bp`` point runs twice on the same seeds, hence the same records and
    decisions: scored by today's representatives, then by the artifact's
    (:func:`bp_artifact_code`), which the gate reads."""
    from exp_ldpc_tpu_torch.experiments import validate_ler as vl

    log(f"== phase 28: validate_ler on the card: pheno bp, circuit bp, circuit bposd at one "
        f"artifact point each, {LER_SHOTS} shots (cut from 401,408-1,000,000), cross-check "
        f"{CROSS_SHOTS} host shots at the bposd point")
    art_code = bp_artifact_code(code)
    by_run = {}
    for noise, decode, p, art, n_art, cross in LER_CASES:
        argv = ["--noise", noise, "--decode", decode, "--samples", str(LER_SHOTS),
                "--p-grid", f"({p!r},{p!r},1)", "--crosscheck-samples", str(CROSS_SHOTS),
                "--device", "cuda"] + ([] if cross else ["--skip-crosscheck"])
        args = vl.parse_args(argv)

        def run():
            rows, pipe, grid, priors = vl.sweep(args, code)
            checks = vl.crosscheck(args, rows, pipe, grid, priors) if cross else []
            scored = vl.sweep(args, art_code)[0] if decode == "bp" else rows
            return rows, pipe, checks, scored
        (rows, pipe, checks, scored), launches = _run_counted(run)
        (row,), (srow,) = rows, scored
        key = f"validate_ler_{noise}_{decode}"
        log(f"  {key}: kernel {pipe.kernel}, failures {row['failures']} / {row['samples']}, "
            f"{row['samples'] / row['walltime']:.0f} shots/s ({row['walltime']:.2f} s), "
            f"launches {launches}")
        if decode == "bp":
            log(f"  the same records scored by the artifact's representatives: failures "
                f"{srow['failures']} (today's: {row['failures']}); unconverged "
                f"{srow['bp_unconverged']} / {row['bp_unconverged']}")
            check(srow["bp_unconverged"] == row["bp_unconverged"],
                  f"{key}: both runs decoded the same records alike")
        _gate(srow["failures"], srow["samples"], art, p, key, noise=noise, samples=n_art)
        kern = {"stbp": "K2", "stbsr": "K3"}[pipe.kernel]
        check(kern == spacetime_choice(pipe.tanner, pipe.rounds, pipe.device,
                                       early_stop=False) == "K2"
              and launches[kern] > 0, f"{key}: the selection's K2 launched")
        for c in checks:
            log(f"  cross-check ({c['crosscheck_chain']}): host {c['host_failures']} / "
                f"{c['host_samples']}, gap {c['gap']:.5f}, 2 sigma {c['two_sigma']:.5f}")
            check(c["agree"], f"{key}: the cross-check agrees (pooled two-proportion, 2 sigma)")
        by_run[key] = launches
    return by_run


def phase_bench_gross() -> tuple:
    from exp_ldpc_tpu_torch.experiments import bench_gross as bg

    log("== phase 29: bench_gross on the card (defaults: gross code x12 rounds, 20,000 shots "
        "x 60 iterations, --msg-dtype bfloat16, grid (1e-3,5e-3,4), one warm-up batch)")
    (rows, pipe), launches = _run_counted(bg.sweep, bg.parse_args(["--device", "cuda"]))
    check(pipe.kernel == "stbp" and launches["K2"] > 0,
          f"the gross code's spacetime stage is K2 ({launches['K2']} launches: warm-up + 4)")
    for row in rows:
        log(f"  p={row['p_ph']:.6g}: failures {row['failures']} / {row['samples']}, "
            f"ler_per_round {row['ler_per_round']:.4g}, {row['shots_per_s']:.0f} shots/s")
    for p in GROSS_GATES:
        (row,) = [r for r in rows if abs(r["p_ph"] - p) <= 1e-9 * p]
        _gate(row["failures"], row["samples"], "gross_memory_12r_v5e.jsonl", p,
              f"bench_gross p={p:.6g}")
    return launches, {f"{r['p_ph']:.4g}": r["shots_per_s"] for r in rows}


def dem4(p: float):
    """validate_dem's 4-round detector model at p (~150 s of host Python;
    built in a spawned process from the start of the run)."""
    from exp_ldpc_tpu_torch.experiments import validate_dem as vd

    return vd.point_dem(p, 4, vd.build_code())


def _dem4_k1_parity(dem) -> float:
    """K1 against its plain version on the 4-round detector model, with the
    decoder validate_dem's stage 1 builds (``BPDetectorCorrect``: min-sum,
    the adaptive alpha 0, 48 iterations, the exit armed) and again at fixed
    iterations: two shot blocks, the first all zero (it stops after one
    iteration), the second drawn at the fault priors.  Returns the worst
    posterior error."""
    from exp_ldpc_tpu_torch.decoders.bp_bsr import BSRBPDecoder
    from exp_ldpc_tpu_torch.decoders.drivers import BPDetectorCorrect

    dev = torch.device("cuda")
    corr = BPDetectorCorrect(dem, {"max_iter": MAX_ITER, "bp_method": "ms",
                                   "ms_scaling_factor": 0.0}, device=dev)
    bp = corr._bpd
    check(type(bp) is BSRBPDecoder and bp.early_stop and bp.check_perm is None
          and bp.inv_var_perm is None,
          "stage 1's decoder is K1's BSRBPDecoder with the exit armed, in the matrix's order")
    dsc = DetectorSpacetimeCode(dem)
    fs = PriorSetup(dsc.fault_check_matrix, dsc.fault_priors, dev, "dem_4r")
    fs.layout = bp.layout
    sb = bp.shot_block
    synd = fs.draw(2 * sb, seed=91, scale=1.0)
    synd[:, :sb] = 0
    log(f"  K1 vs plain on the detector model: {2 * sb} shots (blocks of {sb}, the first all "
        f"zero), min-sum alpha 0, {MAX_ITER} iterations, the exit armed and fixed")
    wide = k1.KERNEL.routes.get("wide", 0)
    worst = 0.0
    for es in (True, False):
        worst = max(worst, _k1_case(fs, synd, bp._prior, "ms", 0.0, es, MAX_ITER, sb))
    it = k1.bsr_bp_decode(bp.layout, bp._prior, synd, "ms", MAX_ITER, 0.0, True, sb)[3]
    check(int(it[0]) == 1 and int(it[sb]) > 1,
          f"the all-zero block stops after 1 iteration, the next after {int(it[sb])}")
    check(k1.KERNEL.routes.get("wide", 0) - wide == 3, "every K1 decode here took route wide")
    return worst


def phase_validate_dem(code, dem_result) -> tuple:
    from exp_ldpc_tpu_torch.experiments import validate_dem as vd

    log(f"== phase 30: validate_dem on the card, default relay path, p={DEM_GATE_P:.6g}, "
        f"{DEM_SAMPLES} samples (the artifact's, uncut) in batches of {DEM_BATCH}, the other "
        "options as default")
    t0 = time.perf_counter()
    dem = dem_result.get()
    log(f"  detector model ready ({time.perf_counter() - t0:.1f} s waited here)")
    H = DetectorSpacetimeCode(dem).fault_check_matrix
    tanner = TannerELL.from_check_matrix(H)
    log(f"  fault matrix {H.shape[0]} x {H.shape[1]}, {H.nnz} edges, check degree "
        f"{tanner.max_check_degree}, {k1.BSRLayout.from_tanner(tanner, 'cpu').num_tiles} BSR "
        "tiles")
    check(flat_choice(tanner, torch.device("cuda")) == "K1",
          "stage 1: the selection sends the detector model to K1 (route wide; the JAX fit "
          "rule refuses K1 here, and its CPU choice is the plain per-shot-freezing core)")
    worst = _dem4_k1_parity(dem)
    torch.cuda.empty_cache()
    args = vd.parse_args(["--p-list", repr(DEM_GATE_P), "--samples", str(DEM_SAMPLES),
                          "--batch-shots", str(DEM_BATCH), "--device", "cuda"])
    ((row,), (times,)), launches = _run_counted(vd.run, args, code, {DEM_GATE_P: dem})
    log(f"  {json.dumps(row)}")
    log(f"  stage times: stage-1 BP {times['stage1_s']:.2f} s (sampling included), relay "
        f"{times['relay_s']:.2f} s, host OSD {times['osd_s']:.2f} s for {row['osd_decoded']} "
        f"shots; launches {launches}")
    check(row["samples"] == DEM_SAMPLES and row["osd_overflow"] == 0,
          "every residue shot relay left reached OSD")
    check(launches["K1"] > 0 and launches["K1"] == k1.KERNEL.routes.get("wide", 0)
          and sum(launches.values()) == launches["K1"],
          f"stage 1 ran K1 on route wide ({launches['K1']} calls; relay plain, OSD on the host)")
    _gate(row["failures"], row["samples"], "ler_hgp225_dem_circuit_v5e.jsonl", DEM_GATE_P,
          "validate_dem")
    return launches, times, worst


def phase_sliding_window_demo() -> tuple:
    from exp_ldpc_tpu_torch.experiments import demo_sliding_window as dsw

    log("== phase 31: demo_sliding_window on the card (defaults: HGP-225, 64 and 128 rounds, "
        "512 shots, p=1e-3, window 4, commit 2)")
    rows, launches = _run_counted(dsw.main, ["--device", "cuda"])
    for row in rows[:2]:
        log(f"  {row['rounds']} rounds: failures {row['failures']} / {row['shots']}, decode "
            f"{row['decode_walltime_s']:.2f} s, {row['decode_ms_per_round_per_kshot']:.1f} ms "
            "per round per 1,000 shots")
        _gate(row["failures"], row["shots"], "sliding_window_v5e.jsonl", row["rounds"],
              f"demo_sliding_window {row['rounds']} rounds", key="rounds",
              bench="sliding_window")
    ratio = rows[2]["walltime_ratio_vs_rounds_ratio"]
    log(f"  walltime ratio / rounds ratio: {ratio:.3f} (the artifact's: 1.09)")
    check(launches["K1"] > 0, f"K1 launched ({launches['K1']} calls: the windows and tails)")
    return launches, ratio


def phase_bench_osd_host() -> tuple:
    from exp_ldpc_tpu_torch.experiments import bench_osd_host as boh

    log("== phase 32: bench_osd_host (defaults: HGP-225 x4 circuit noise p=1.2e-3, 4,096 "
        "shots harvested by K2, 512 OSD shots, order 7, 1/2/all threads; host numbers)")
    rows, launches = _run_counted(boh.main, ["--device", "cuda"])
    check(len(rows) == 6, "six rows: every output satisfied its syndrome")
    check(launches["K2"] > 0, "the harvest ran K2")
    return launches, {f"{r['method']}_t{r['nthreads']}": r["shots_per_s"] for r in rows}


def phase_bench_spacetime(su: Setup) -> tuple:
    """K6 and K2 held to their plain versions on the benchmark's own first
    batches (both methods), then the benchmark, counted.  Returns its
    launches, its ms per batch and the worst posterior error by kernel."""
    from exp_ldpc_tpu_torch.experiments import bench_spacetime as bst

    log(f"== phase 33: bench_spacetime (generic K6 vs structured K2, plain versions beside; "
        f"HGP-225 x{ROUNDS}, {bst.SHOTS} shots x {bst.ITERS}, slope over {bst.N_LO} and "
        f"{bst.N_HI} batches); first K6 and K2 vs plain on its {bst.N_LO} first batches")
    gen, base, prior, lo, _hi = bst.inputs(ROUNDS, su.dev)
    check((gen.num_checks, gen.num_vars) == su.H.shape,
          f"the benchmark's flat matrix is HGP-225's {ROUNDS}-round spacetime matrix")
    err = {"K6": 0.0, "K2": 0.0}
    for b, synd in enumerate(lo):
        for method, msf in (("ms", bst.ALPHA), ("ps", 0.0)):
            tag = f"batch {b} {method} alpha={msf} S={synd.shape[1]} x {bst.ITERS}"
            plan = k6.launch_plan(gen, synd.shape[1], su.dev)
            kern = k6.bp_fixed(gen, prior, synd, method, bst.ITERS, msf, plan=plan)
            plain = bp_core(gen, prior, synd, method, bst.ITERS, msf, early_stop=False)
            torch.cuda.synchronize()
            err["K6"] = max(err["K6"], _same(f"K6 generic {tag} [{_plan_tag(plan)}]", su, synd,
                                             kern, plain))
            plan = k2.launch_plan(base, ROUNDS, synd.shape[1], su.dev)
            kern = k2.stbp_fixed(base, ROUNDS, prior, synd, method, bst.ITERS, msf, plan=plan)
            plain = stbp_core(base, ROUNDS, prior, synd, method, bst.ITERS, msf,
                              early_stop=False)
            torch.cuda.synchronize()
            err["K2"] = max(err["K2"], _same(f"K2 structured {tag} [{_plan_tag(plan)}]", su,
                                             synd, kern, plain))
    out, launches = _run_counted(bst.main, ["--device", "cuda"])
    check(launches["K6"] > 0 and launches["K2"] > 0, "K6 and K2 launched")
    check(all(kind == "slope" for kind in out["time_kind"].values()),
          f"every time is a slope, none an upper bound: {out['time_kind']}")
    return launches, out["ms_per_batch"], err


def phase_bench_scaling() -> tuple:
    from exp_ldpc_tpu_torch.experiments import bench_scaling as bsc

    log("== phase 34: bench_scaling on this card (devices = 1: HGP-225 x4, 1,024 shots x 32, "
        "4 batches)")
    rows, launches = _run_counted(bsc.main, [])
    check([r["devices"] for r in rows] == [1] and launches["K2"] > 0,
          f"one row, devices = 1, K2 launched ({launches['K2']})")
    return launches, rows[0]["decoded_shots_per_s"]


STBSR_LER_ART = "stbsr_ler_v5e.jsonl"   # 603 / 830 / 1,105 of 2,048 (629 / 881 / 1,195 unconverged)
STBSR_LER_SHOTS, STBSR_LER_ROUNDS = 2048, 8


def phase_stbsr_ler(dev: torch.device) -> tuple:
    """bench_stbsr --ler uncut, counted; then K3 at the chain's shape held to
    its plain version (the p = 1.2e-3 point) and timed.  Returns the
    launches, K3's times and bound, and the worst posterior error."""
    from exp_ldpc_tpu_torch.experiments import bench_stbsr as bs

    log(f"== phase 35: bench_stbsr --ler on the card, uncut: cyclic LP n=4,862 x"
        f"{STBSR_LER_ROUNDS} rounds, {STBSR_LER_SHOTS} shots a point at p = "
        f"{', '.join(f'{p:g}' for p in bs.LER_PS)}: device sampler -> spacetime syndromes -> K3 "
        f"({bs.LER_ITERS} min-sum iterations, the global exit armed) -> final correction -> "
        "logical test")
    inputs = []
    rows, launches = _run_counted(
        lambda: bs.ler_chain(STBSR_LER_SHOTS, STBSR_LER_ROUNDS, dev, inputs=inputs))
    for row in rows:
        art = _artifact_row(STBSR_LER_ART, row["p"], key="p")
        log(f"  p={row['p']:g}: failures {row['failures']} / {row['shots']} (artifact "
            f"{art['failures']}), bp_unconverged {row['bp_unconverged']} (artifact "
            f"{art['bp_unconverged']}), iters {row['iters']} (artifact {art['iters']}), decode "
            f"{row['decode_walltime_s']:.3f} s")
        _gate(row["failures"], row["shots"], STBSR_LER_ART, row["p"],
              f"bench_stbsr --ler p={row['p']:g}", key="p")
    lers = [row["ler"] for row in rows]
    check(lers == sorted(lers), f"the LERs grow with p: {lers}")
    check(launches["K3"] == len(rows), f"K3 launched once a point ({launches['K3']})")
    Hz = bs._cyclic(logicals=True).checks.z   # the chain's code (cached)
    st = Checks(SpacetimeCode(Hz, STBSR_LER_ROUNDS).spacetime_check_matrix, dev,
                f"cyclic LP n=4862 x{STBSR_LER_ROUNDS}")
    dec, synd = inputs[-1]
    kern = dec.decode_tensors(synd)
    plain, ms_plain = _timed(lambda: k3.stbsr_decode(
        dec.tables, dec.num_rounds, dec._prior, synd, dec.method, dec.max_iter,
        dec.ms_scaling_factor, True, iterate=k3._stbsr_iter_plain))
    err = _same(f"K3 at the chain's shape, p={rows[-1]['p']:g}, {STBSR_LER_SHOTS} shots, exit "
                "armed", st, synd, kern, plain)
    runs = [_timed(lambda s=s, d=d: d.decode_tensors(s)) for d, s in inputs]
    t = {"K3_stbsr_ler": float(np.median([ms for _out, ms in runs])),
         "K3_stbsr_ler_plain": ms_plain}
    shot_iters = float(np.median([STBSR_LER_SHOTS * int(out[3][0]) for out, _ms in runs]))
    t["stbsr_ler_bound"] = _k3_bound(st, dec.tables, STBSR_LER_SHOTS, shot_iters)
    log(f"  K3 decode (CUDA events, median of the 3 points): {t['K3_stbsr_ler']:.2f} ms, plain "
        f"{ms_plain:.1f} ms (the p={rows[-1]['p']:g} point, one run); bound "
        f"{t['stbsr_ler_bound']['bound_ms']:.3f} ms ({t['stbsr_ler_bound']['bound_by']}, "
        f"{shot_iters / STBSR_LER_SHOTS:.0f} iterations)")
    return launches, t, err


def phase_quickstart() -> dict:
    """The README quickstart, its three steps as written, on the card."""
    import exp_ldpc_tpu_torch as qldpc
    from exp_ldpc_tpu_torch.misc import run_simulation

    log("== phase 36: the README quickstart on the card (import exp_ldpc_tpu_torch as qldpc; "
        "biregular_hgp(12, 3, 4, seed=42), circuit noise, run_simulation 4,096 samples bposd)")
    code = qldpc.biregular_hgp(12, 3, 4, seed=42, compute_logicals=True)
    check((code.num_qubits, code.num_logicals) == (225, 9), "the code is (225, 9)")
    sim = qldpc.build_storage_simulation(
        rounds=4, noise_model=qldpc.noise_model.circuit_noise(1e-3, 1e-3), code=code)
    for line in sim.circuit[:6]:
        log(f"  {line[:100]}")
    failures, launches = _run_counted(lambda: run_simulation(
        samples=4096, code=code, rounds=4,
        noise_model=qldpc.noise_model.depolarizing_noise,
        noise_model_args=dict(p=1e-3, pm=1e-3),
        meas_prior=lambda xs, zs: 2e-3 / 3, data_prior=lambda xs, zs: 2e-3 / 3,
        bp_osd_options=dict(bp_method="ms", ms_scaling_factor=0.625,
                            max_iter=60, osd_method="osd_cs", osd_order=7),
        decoder_mode="bposd", seed=0, device="cuda"))
    log(f"  {sum(failures)} logical failures of {len(failures)}; launches {launches}")
    check(len(failures) == 4096 and 0 <= sum(failures) < 4096, "4,096 decoded samples")
    check(launches["K3"] > 0, f"the bposd spacetime BP ran K3 ({launches['K3']})")
    return launches


def selection_regimes(dem1: "PriorSetup", dem4):
    """(label, request, case) of phase 37: one shape per selection point and
    regime of the rule (``experiments/bench_select.py``'s cases, cut), the
    early-stop calls both where the exit never fires (the host redecodes) and
    where the batch converges in a few iterations."""
    from exp_ldpc_tpu_torch.experiments import bench_select as bs

    hz = biregular_hgp(12, 3, 4, seed=0).checks.z
    HI = SpacetimeCodeSingleShot(hz).spacetime_check_matrix
    big = biregular_hgp(160, 3, 4, seed=11).checks.z
    dsc4 = DetectorSpacetimeCode(dem4)
    return [
        ("bposd device step: K2 resident", "fixed",
         bs.spacetime_case("hgp225", hz, ROUNDS, P_HI, (16384,), MAX_ITER)),
        ("bposd host redecode (drivers.py BPOSDCorrect; hard shots): K3 armed", "early_stop",
         bs.spacetime_case("hgp225_hard", hz, ROUNDS, 3 * P_HI, (S_REDECODE,), MAX_ITER)),
        ("two-tier regime: K2 streams, K3", "fixed",
         bs.spacetime_case("cyclic_lp_4862", bench_bsr_shard.build_code("cyclic4862"), 4, 2e-4,
                           (2048,), MAX_ITER)),
        ("bench_bp's fixed call on HGP-225's H (1,024 shots x 32): K6, 71 shots a block",
         "fixed", bs.flat_case("hgp_225", hz, 1e-3, shots=(1024,), iters=32)),
        ("(H|I) at the single-shot mode's p, 16,384 shots (it converges): K1 armed",
         "early_stop", bs.flat_case("hgp225_HI", HI, 2 / 3 * 0.002, shots=(16384,))),
        ("single-shot host redecode on (H|I) (hard shots): K1 armed", "early_stop",
         bs.flat_case("hgp225_HI_hard", HI, 9 * 2 / 3 * 0.002, shots=(S_REDECODE,))),
        ("QC-LP [[1054,140]], 16,384 shots at p = 1e-3 (it converges): K1 armed", "early_stop",
         bs.flat_case("qclp_1054_140", bench_large_codes._qclp_H(), 1e-3, (31,),
                      shots=(16384,))),
        ("flat BP at n = 40,000 (K1b's shape): K6 streams, K1", "fixed",
         bs.flat_case("hgp_40000", big, 5e-4, shots=(256,), iters=8)),
        ("flat BP at n = 40,000, the callers' 48 iterations: K1 armed", "early_stop",
         bs.flat_case("hgp_40000", big, 5e-4, shots=(S_REDECODE,))),
        ("1-round circuit DEM, 53-slot checks: K6 streams (2 shots would fit a block), K1",
         "fixed",
         bs.flat_case("dem_1r", dem1.H, dem1.priors, shots=(1024,))),
        ("cyclic lifted product n = 4,862 flat, 2,048 x 48 (24 slots): K6 streams, K1", "fixed",
         bs.flat_case("cyclic_lp_4862", bench_large_codes._cyclic_H(), 1e-3, shots=(2048,))),
        ("validate_dem stage 1, 4-round DEM (435 slots): K1 armed", "early_stop",
         bs.flat_case("dem_4r", dsc4.fault_check_matrix, dsc4.fault_priors, shots=(1024,))),
    ]


def phase_selection(dev: torch.device, smi: str, dem1: "PriorSetup", dem4_result) -> list:
    """The decoder selection against every candidate it chooses among, at one
    shape per selection point and regime: each candidate timed on the same
    syndromes (``bench_select.measure``: CUDA events, median of 3 distinct
    batches); the automatic choice must be within 10% of the fastest
    candidate of the caller's request.  A fixed-iteration call allows the
    fixed-iteration decoders (K6, K2, K1 and K3 unarmed, the plain roll
    decoder); an early-stop call the decoders with an exit (K1's and K3's
    armed exits, the plain cores' per-shot freezing, the roll decoder's).
    At an early-stop call the fixed-iteration decoders are timed and printed
    beside, not allowed: what the exit saves or costs in that regime.  The
    rule's shared memory must be the card's.  Returns the rows."""
    from exp_ldpc_tpu_torch.experiments import bench_select as bs

    log("== phase 37: the decoder selection against its candidates, one shape per "
        "selection point and regime (bench_select's cases, cut)")
    info = bs.card(dev)   # raises unless the selection reads the card's shared memory
    log(f"  the selection reads the card's {select.smem_optin(dev)} B of opt-in shared memory "
        f"per block (the rows' H100: {select.H100_SMEM_OPTIN})")
    rows = []
    for label, request, case in selection_regimes(dem1, dem4_result.get()):
        S = case.shots[0]
        auto = bs.auto_candidate(case, request, dev)
        pool = [c for c in bs.candidates(case) if request == "early_stop"
                or c.request == "fixed"]
        measured = [bs.measure(case, S, c, 3, dev, info) for c in pool]
        timed = [r for r in measured if r["ms"] is not None]
        allowed = [r for r in timed if r["request"] == request]
        best = min(allowed, key=lambda r: r["ms"])
        (mine,) = [r for r in timed if (r["candidate"], r["request"]) ==
                   (auto.name, auto.request)]
        log(f"  {label}: {case.code} {'x' + str(case.rounds) + ' ' if case.rounds else ''}"
            f"{S} shots x {case.iters}, {request}: "
            + ", ".join(f"{r['candidate']}/{r['request']} "
                        + (f"{r['ms']:.3f} ms [{r['route']}; conv {r['converged']:.3f}, iters "
                           f"{r['iters_mean']:.1f}]" if r["ms"] is not None
                           else "not run (" + r["skipped"] + ")") for r in measured))
        check(mine["ms"] <= 1.10 * best["ms"],
              f"{case.code}: the selection's {auto.name}/{auto.request} ({mine['ms']:.3f} ms) "
              f"within 10% of the fastest allowed, {best['candidate']}/{best['request']} "
              f"({best['ms']:.3f} ms)")
        rows += [dict(r, regime=label, auto=r is mine, allowed=r in allowed) for r in measured]
    log(f"  card: {smi}")
    return rows


# ---------------------------------------------------------------------------
# Bounds: the least time the card could take for each kernel's `ms` shape
# (exp_ldpc_tpu_torch/utils/bounds.py: bytes over 3.35 TB/s, operations over
# 67 TFLOP/s)
# ---------------------------------------------------------------------------


def _bound(nbytes: float, ops: float) -> dict:
    return {**bound(nbytes, ops), "library_ms": None}


def _k3_bound(st: Checks, tab, shots: int, shot_iters: float) -> dict:
    """K3's bound for a decode of ``shots`` over the spacetime matrix
    ``st.H`` (base tables ``tab``) that ran ``shot_iters`` shot-iterations
    (one global exit: ``shot_iters / shots`` iterations).  Every iteration
    moves the decode's bytes and reads and writes the bf16 messages (one
    value per spacetime edge and shot)."""
    nnz = st.H.nnz
    return _bound(shot_iters / shots * (_st_io(*st.H.shape, tab, shots) + 2 * 2 * nnz * shots),
                  OPS_FLOAT * nnz * shot_iters)


def kernel_bounds(su: Setup, flats, big, fams, cap, k3b_shape, gross, dem, t,
                  cyclic_H) -> dict:
    """Bound of each kernel at the shape its ``ms`` was timed at (K1, K2, K5
    and K6 also at their other timed shapes: ``bound_ms_<tag>``).  With the
    early exit the operations are those of the shot-iterations the timed
    batches needed (``t``'s ``K1_<tag>_shot_iters``)."""
    S = 16384
    Hss = flats[1]
    out = {}
    # K1, K6: (H|I), 16,384 shots x 48 iterations, fixed (K1 also reads nslot)
    E = Hss.H.nnz
    out["K6"] = _bound(_flat_io(Hss.tables, S), OPS_FLOAT * E * S * MAX_ITER)
    for tag, fs, shots, iters in ((f"S{S_REDECODE}", Hss, S_REDECODE, MAX_ITER),
                                  ("bench", flats[0], 1024, 32)):
        b = _bound(_flat_io(fs.tables, shots), OPS_FLOAT * fs.H.nnz * shots * iters)
        out["K6"][f"bound_ms_{tag}"] = b["bound_ms"]
        out["K6"][f"bound_by_{tag}"] = b["bound_by"]
    out["K1"] = _bound(_flat_io(Hss.tables, S) + 4 * Hss.tables.num_checks,
                       OPS_FLOAT * E * S * MAX_ITER)
    qclp, cyc = fams
    for tag, fs, shots, iters in (("bench", flats[0], 1024, 32),
                                  (f"S{S}_es", Hss, S, None),
                                  (f"S{S_REDECODE}_es", Hss, S_REDECODE, None),
                                  ("fam_cyclic", cyc, FAM_SHOTS, FAM_ITERS),
                                  ("fam_qclp", qclp, FAM_SHOTS, FAM_ITERS)):
        shot_iters = t[f"K1_{tag}_shot_iters"] if iters is None else shots * iters
        b = _bound(_flat_io(fs.tables, shots) + 4 * fs.tables.num_checks,
                   OPS_FLOAT * fs.H.nnz * shot_iters)
        out["K1"][f"bound_ms_{tag}"] = b["bound_ms"]
        out["K1"][f"bound_by_{tag}"] = b["bound_by"]
    # K1b: n = 40,000 HGP, 256 shots x 8 iterations
    out["K1b"] = _bound(_flat_io(big.tables, 256) + 4 * big.tables.num_checks,
                        OPS_FLOAT * big.H.nnz * 256 * 8)
    # K2: the spacetime decode in one launch: spacetime syndromes and priors
    # in, base tables, posterior, conv, iters out
    rows, cols = su.H.shape
    st_io = _st_io
    out["K2"] = _bound(st_io(rows, cols, su.tables, S), OPS_FLOAT * su.H.nnz * S * MAX_ITER)
    gtab, gst = gross
    for tag, chk, tab, shots, iters in ((f"S{S_REDECODE}", su, su.tables, S_REDECODE, MAX_ITER),
                                        ("gross", gst, gtab, S, GROSS_ITERS)):
        b = _bound(st_io(*chk.H.shape, tab, shots), OPS_FLOAT * chk.H.nnz * shots * iters)
        out["K2"][f"bound_ms_{tag}"] = b["bound_ms"]
        out["K2"][f"bound_by_{tag}"] = b["bound_by"]
    # K3: 16,384 x 48; at the redecode's 685 shots, and both shapes with the exit armed (the
    # iterations the timed batches needed); the two-tier device steps (phase 25); the LER
    # chain's decode (phase 35: the iterations its decodes ran)
    out["K3"] = _k3_bound(su, su.tables, S, S * MAX_ITER)
    for tag, shots, shot_iters in ((f"S{S_REDECODE}", S_REDECODE, S_REDECODE * MAX_ITER),
                                   ("early_stop", S, t["K3_es_shot_iters"]),
                                   (f"S{S_REDECODE}_early_stop", S_REDECODE,
                                    t[f"K3_S{S_REDECODE}_es_shot_iters"])):
        b = _k3_bound(su, su.tables, shots, shot_iters)
        out["K3"][f"bound_ms_{tag}"], out["K3"][f"bound_by_{tag}"] = b["bound_ms"], b["bound_by"]
    for tag in ("two_tier_fixed_step", "two_tier_step", "stbsr_ler"):
        b = t[f"{tag}_bound"]
        out["K3"][f"bound_ms_{tag}"], out["K3"][f"bound_by_{tag}"] = b["bound_ms"], b["bound_by"]
    st, tab, shots, iters = k3b_shape
    out["K3b"] = _k3_bound(st, tab, shots, shots * iters)
    # K4: one decode iteration, all D shards: per shard the posterior in and
    # the partial out (f32, V_pad x S), its messages in and out (bf16), its
    # syndromes and tables
    H, dec, rec = cap
    D, sb = rec["shards"], dec.sharded
    out["K4"] = _bound(D * 2 * 4 * sb.v_pad * 128 + 2 * 2 * H.nnz * 128 + H.shape[0] * 128
                       + 2 * 4 * H.nnz, OPS_FLOAT * H.nnz * 128)
    # the same per iteration at bench_bsr_shard's cyclic n = 4,862, 1,024 shots, D = 1, 2, 4
    for D in (1, 2, 4):
        v_pad = k4.ShardedBSRDecoder.from_check_matrix(
            cyclic_H, D, error_rate=1e-3, max_iter=32, bp_method="ms",
            device=su.dev).sharded.v_pad
        b = _bound(D * 2 * 4 * v_pad * 1024 + 2 * 2 * cyclic_H.nnz * 1024
                   + cyclic_H.shape[0] * 1024 + 2 * 4 * cyclic_H.nnz,
                   OPS_FLOAT * cyclic_H.nnz * 1024)
        out["K4"][f"bound_ms_bench_D{D}"] = b["bound_ms"]
        out["K4"][f"bound_by_bench_D{D}"] = b["bound_by"]
    # K5: the cyclic n = 4,862 code and the QC-LP, 1,024 shots x 32 iterations, fixed
    out["K5"] = _bound(_flat_io(cyc.tables, FAM_SHOTS),
                       OPS_INT8 * cyc.H.nnz * FAM_SHOTS * FAM_ITERS)
    b = _bound(_flat_io(qclp.tables, FAM_SHOTS), OPS_INT8 * qclp.H.nnz * FAM_SHOTS * FAM_ITERS)
    out["K5"]["bound_ms_qclp"], out["K5"]["bound_by_qclp"] = b["bound_ms"], b["bound_by"]
    # K1 and K5 at the detector model's 53-slot checks, 4,096 shots x 48, fixed
    for key, ops in (("K1", OPS_FLOAT), ("K5", OPS_INT8)):
        b = _bound(_flat_io(dem.tables, 4096) + (4 * dem.tables.num_checks if key == "K1" else 0),
                   ops * dem.H.nnz * 4096 * MAX_ITER)
        out[key]["bound_ms_dem_dc53"], out[key]["bound_by_dem_dc53"] = b["bound_ms"], b["bound_by"]
    # bench_spacetime's shapes (phase 33): HGP-225 x4, 1,024 shots x 32 iterations, K6 flat on
    # the spacetime matrix, K2 structured
    st_tables = tanner_tables(TannerELL.from_check_matrix(su.H), su.dev)
    for key, nbytes in (("K6", _flat_io(st_tables, 1024)),
                        ("K2", _st_io(*su.H.shape, su.tables, 1024))):
        b = _bound(nbytes, OPS_FLOAT * su.H.nnz * 1024 * 32)
        out[key]["bound_ms_spacetime"], out[key]["bound_by_spacetime"] = (b["bound_ms"],
                                                                          b["bound_by"])
    # the streamed routes of K2 and K6 do the same work at the main shape: the same bound
    for key in ("K2", "K6"):
        out[key]["bound_ms_streamed"] = out[key]["bound_ms"]
        out[key]["bound_by_streamed"] = out[key]["bound_by"]
    return out


def streamed_dm_bounds(su: Setup, flats, dense) -> dict:
    """The device-memory bound (``streamed_bound``) of the streamed shapes
    timed in phases 8, 12 and 24: HGP-225 x4 and (H|I) at 16,384 x 48 forced
    streamed, the dense HGP x4 and its (H|I), 1,024 x 24 (route wide)."""
    S, Hss = 16384, flats[1]
    H = dense.checks.z
    dtab = tanner_tables(TannerELL.from_check_matrix(H), su.dev)
    dst = SpacetimeCode(H, WIDE_ROUNDS).spacetime_check_matrix.tocsr()
    dss = FlatSetup(SpacetimeCodeSingleShot(H).spacetime_check_matrix, su.dev, "dense (H|I)")
    return {"K2_streamed": streamed_bound(_st_io(*su.H.shape, su.tables, S), su.H.shape[0],
                                          su.tables, su.H.nnz, S, MAX_ITER),
            "K6_streamed": streamed_bound(_flat_io(Hss.tables, S), Hss.H.shape[0], Hss.tables,
                                          Hss.H.nnz, S, MAX_ITER),
            "K2_wide_dense_streamed": streamed_bound(_st_io(*dst.shape, dtab, 1024), dst.shape[0],
                                                     dtab, dst.nnz, 1024, WIDE_ITERS),
            "K6_wide_ss_streamed": streamed_bound(_flat_io(dss.tables, 1024), dss.H.shape[0],
                                                  dss.tables, dss.H.nnz, 1024, WIDE_ITERS)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="build, kernel parity at small sizes and the sampler only "
                    "(a first check of new kernels)")
    args = ap.parse_args()
    t_start = time.perf_counter()

    def phase(fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        log(f"  [{fn.__name__}: {time.perf_counter() - t0:.1f} s, "
            f"{time.perf_counter() - t_start:.1f} s in all]")
        return out

    smi = phase(phase_card)
    dev = torch.device("cuda")
    su = Setup(dev)
    n_dev, n_host = (8192, 2048) if args.quick else (65536, 16384)
    # host work beside the build and the first parity phases
    bg = ThreadPoolExecutor(5)
    dem4_result = None
    if not args.quick:
        # validate_dem's 4-round detector model (~150 s of host Python) in its
        # own process from the start: a thread would hold the GIL the phases need
        dem_pool = multiprocessing.get_context("spawn").Pool(1)
        atexit.register(dem_pool.terminate)
        dem4_result = dem_pool.apply_async(dem4, (DEM_GATE_P,))
    host = bg.submit(host_rates, su, n_host)
    dem_fut = bg.submit(dem_matrix, su.code)
    host_mats = None if args.quick else bg.submit(host_path_matrices, su.code)
    st_codes = None if args.quick else bg.submit(streamed_setups)
    phase(phase_build)
    world = None if args.quick else bg.submit(dist_world)
    rs_world = None if args.quick else bg.submit(rounds_world)
    # ragged shot edges (97, S_REDECODE) and the main path's batch (16,384)
    sizes = (97, 512) if args.quick else (S_REDECODE, 4096, 16384)
    err, parity_routes = {}, {}
    err["K2"], parity_routes["K2"] = phase(phase_k2, su, sizes, dev)
    err["K3"] = phase(phase_k3, su, sizes, (97,) if args.quick else (97, S_REDECODE))
    phase(phase_sampler, su, dev, n_dev, n_host, host)
    src = "exp_ldpc_tpu_torch/csrc/"
    kernels = [
        {"name": "K1 bsr_bp_run (one count = one decode: up to 3 grids per iteration)",
         "route": "cuda", "source": src + "bsr_bp.cu",
         "replaces": "exp_ldpc_tpu/decoders/bp_bsr.py:226"},
        {"name": "K1b bsr_bp (served by K1: the same kernel and count)", "route": "cuda",
         "source": src + "bsr_bp.cu", "replaces": "exp_ldpc_tpu/decoders/bp_bsr.py:546"},
        {"name": "K2 stbp_fixed", "route": "cuda", "source": src + "stbp.cu",
         "replaces": "exp_ldpc_tpu/decoders/spacetime_bp_pallas.py:65"},
        {"name": "K3 stbsr_run (one count = one decode: 3 grids per iteration)", "route": "cuda",
         "source": src + "stbsr.cu",
         "replaces": "exp_ldpc_tpu/decoders/bp_bsr_spacetime.py:113"},
        {"name": "K3b stbsr_run (served by K3: the same kernels; decodes at K3b's sizes, "
                 "phase 17)", "route": "cuda",
         "source": src + "stbsr.cu", "replaces": "exp_ldpc_tpu/decoders/bp_bsr_spacetime.py:306"},
        {"name": "K4 bsr_shard (one count = one iteration of one shard: 2 grids)",
         "route": "cuda", "source": src + "bsr_shard.cu",
         "replaces": "exp_ldpc_tpu/decoders/bp_bsr_shard.py:200"},
        {"name": "K5 bsr_bp_int8_run (one count = one decode: up to 3 grids per iteration)",
         "route": "cuda", "source": src + "bsr_bp_int8.cu",
         "replaces": "exp_ldpc_tpu/decoders/bp_bsr.py:799"},
        {"name": "K6 bp_fixed", "route": "cuda", "source": src + "bpflat.cu",
         "replaces": "exp_ldpc_tpu/decoders/bp_pallas.py:123"},
    ]
    if not args.quick:
        # The main path, run by run, each counted from 0: the bposd p_sweep
        # (the selection's K2 in the device step at HGP-225, K3 in the host
        # redecode), the same pipeline on K3 (bp_backend "stbsr"), and the
        # single-shot and hybrid p_sweeps (K6 on the device, K1 in the host
        # redecode; K2 in the hybrid spacetime stage, K3 in its redecode);
        # later the capacity decode (K4) and the code-family benchmark (K1, K5).
        by_run = {"distributed_2rank": phase(phase_distributed, dev, world),
                  "p_sweep_bposd": phase(phase_main_path, su, dev, 65536, 16384),
                  "pipeline_stbsr": phase(phase_k3_pipeline, su, dev, 16384)}
        t = phase(phase_timings, su, dev, 16384)
    flats, big = flat_setups(su, dev)
    err["K6"], parity_routes["K6"] = phase(phase_k6, flats, big, sizes, dev)
    cyclic_H = bench_bsr_shard.build_code("cyclic4862")
    fams = family_setups(dev, cyclic_H)
    err["K1"], err["K1b"] = phase(phase_k1, flats, big, fams[1], sizes, args.quick)
    err["K5"] = phase(phase_k5, flats, fams, sizes, dev)
    dem = PriorSetup(*dem_fut.result(), dev, "dem_dc53")
    err_dem, dem_times = {}, {}
    err_dem["K1"], err_dem["K5"], dem_times = phase(phase_dem_kernels, dem, not args.quick)
    if not args.quick:
        err_host_k1 = phase(phase_host_path_kernels,
                            [(PriorSetup(H, pr, dev, name), S, opts)
                             for name, H, pr, S, opts in host_mats.result()])
    if not args.quick:
        by_run.update(phase(phase_modes, dev, 65536, 16384))
    k4_sizes = (97, 512) if args.quick else (97, S_REDECODE, 4096)
    cap = None if args.quick else shard_capacity.build(device=dev)
    err["K4"], err_k4_big = phase(phase_k4, dev, k4_sizes, cap)
    if not args.quick:
        phase(phase_k4_vs_k1, dev)
        by_run["shard_capacity"] = phase(phase_shard_capacity, cap)
        err["K3b"], k3b_launches, k3b_shapes = phase(phase_k3b, dev, t)
        by_run["bench_large_codes"], fam_rows = phase(phase_families, dev)
        host_runs, host_speed = phase(phase_host_path, su.code, dev)
        by_run.update(host_runs)
    dense = dense_hgp()
    err_wide, t_wide, b_wide, shapes_wide = phase(phase_wide, dense, dem, dev,
                                                  256 if args.quick else 1024, not args.quick)
    if not args.quick:
        by_run.update(phase(phase_wide_sweeps, dense, dem, dev, 256))
        err_st38, st38_runs, t_st38, b_st38 = phase(phase_streamed, dev, st_codes)
        by_run.update(st38_runs)
        tt_runs, t_tt, tt_speed, err_tt = phase(phase_two_tier, su, dev)
        by_run.update(tt_runs)
        phase(phase_rounds_shard, dev, rs_world)
        prof = phase(phase_profiler, su, dev)
        # the counterparts of scripts/, each run counted from 0
        by_run.update(phase(phase_validate_ler, su.code))
        by_run["bench_gross"], gross_speed = phase(phase_bench_gross)
        by_run["validate_dem"], vdem_times, err_dem4 = phase(phase_validate_dem, su.code,
                                                             dem4_result)
        by_run["demo_sliding_window"], sw_ratio = phase(phase_sliding_window_demo)
        by_run["bench_osd_host"], osd_speed = phase(phase_bench_osd_host)
        by_run["bench_spacetime"], st_ms, err_st = phase(phase_bench_spacetime, su)
        by_run["bench_scaling"], scaling_rate = phase(phase_bench_scaling)
        by_run["bench_stbsr_ler"], t_ler, err_ler = phase(phase_stbsr_ler, dev)
        by_run["quickstart"] = phase(phase_quickstart)
        sel_rows = phase(phase_selection, dev, smi, dem, dem4_result)
        launches = {name: sum(c[name] for c in by_run.values()) for name in KERNELS}
        for name, n in launches.items():
            check(n > 0, f"{name} launched on the main path ({n} launches)")
        t.update(phase(phase_flat_timings, flats, big, dev, 16384))
        t.update(phase(phase_shard_timings, dev, cap, cyclic_H))
        t.update(phase(phase_family_timings, fams, fam_rows))
        t.update(dem_times)
        t.update(t_tt)
        t.update(t_ler)
        bounds = kernel_bounds(su, flats, big, fams, cap, k3b_shapes["HGP"], _gross(dev), dem, t,
                               cyclic_H)
        b_dm = streamed_dm_bounds(su, flats, dense)
        timing = {"K1": ("K1_S16384", "bench", "S16384_es", f"S{S_REDECODE}_es", "fam_cyclic",
                         "fam_qclp", "dem_dc53"),
                  "K1b": ("K1_n40000",),
                  "K2": ("K2", f"S{S_REDECODE}", "gross"),
                  "K3": ("K3", f"S{S_REDECODE}", "stbsr_ler"),
                  "K3b": ("K3b_HGP", "cyclic"),
                  "K4": ("K4_capacity_D8", "bench_D1", "bench_D2", "bench_D4"),
                  "K5": ("K5_cyclic", "qclp", "dem_dc53"),
                  "K6": ("K6_S16384", "bench", f"S{S_REDECODE}")}
        for kern in kernels:
            key = kern["name"].split()[0]
            if key == "K3b":
                kern.update(launches=k3b_launches,
                            launches_by_run={"k3b_regime": k3b_launches})
            else:
                count = {"K1b": "K1"}.get(key, key)
                kern.update(launches=launches[count],
                            launches_by_run={run: c[count] for run, c in by_run.items()})
            main_t, *more = timing[key]
            kern.update(ms=t[main_t], plain_ms=t[f"{main_t}_plain"])
            for tag in more:
                kern[f"ms_{tag}"] = t[f"{key}_{tag}"]
                kern[f"plain_ms_{tag}"] = t[f"{key}_{tag}_plain"]
            kern.update(bounds[key])
            kern["routes"] = ({"default": k3b_launches} if key == "K3b" else
                              dict(MAIN_ROUTES[{"K1b": "K1"}.get(key, key)]))
            if key in parity_routes:
                kern["routes_parity_phase"] = parity_routes[key]
                kern["ms_streamed"] = t[f"{main_t}_streamed"]
                # bench_spacetime's slope times (phase 33): K6 generic, K2 structured
                name = {"K6": "generic", "K2": "structured"}[key]
                kern["ms_spacetime"] = st_ms[name]
                kern["plain_ms_spacetime"] = st_ms[f"{name}_plain"]
                kern["max_abs_err_spacetime"] = err_st[key]
            if key in err_st38:   # phase 38: the streamed route at the slice's shapes
                kern["max_abs_err_streamed"] = err_st38[key]
                for tag, b in b_st38.items():
                    if tag.startswith(key + "_"):
                        short = tag[len(key) + 1:]
                        kern[f"ms_{short}"] = t_st38[tag]
                        kern[f"plain_ms_{short}"] = t_st38[f"{tag}_plain"]
                        kern[f"bound_ms_{short}"] = b["on_chip"]["bound_ms"]
                        kern[f"bound_by_{short}"] = b["on_chip"]["bound_by"]
                        kern[f"bound_dm_ms_{short}"] = b["device_memory"]["bound_ms"]
                        kern[f"bound_dm_by_{short}"] = b["device_memory"]["bound_by"]
                        kern[f"shape_{short}"] = b["shape"]
                for tag, b in b_dm.items():
                    if tag.startswith(key + "_"):
                        kern[f"bound_dm_ms_{tag[len(key) + 1:]}"] = b["bound_ms"]
            if key == "K5":
                kern["rows_iter_shots_per_s"] = {
                    f"{c}/{f}": r["bp_iter_shots_per_s"] for (c, f), r in fam_rows.items()}
            if key == "K3":
                kern["ms_early_stop"] = t["K3_es"]
                kern["plain_ms_early_stop"] = t["K3_es_plain"]
                kern[f"ms_S{S_REDECODE}_early_stop"] = t[f"K3_S{S_REDECODE}_es"]
                kern[f"plain_ms_S{S_REDECODE}_early_stop"] = t[f"K3_S{S_REDECODE}_es_plain"]
            for tag in (k for k in t_wide if k.startswith(f"{key}_wide_")
                        and not k.endswith("_plain")):
                short = tag[len(key) + 1:]
                kern[f"ms_{short}"] = t_wide[tag]
                kern[f"plain_ms_{short}"] = t_wide[f"{tag}_plain"]
                kern[f"bound_ms_{short}"] = b_wide[tag]["bound_ms"]
                kern[f"bound_by_{short}"] = b_wide[tag]["bound_by"]
                kern[f"shape_{short}"] = shapes_wide[tag]
            if key == "K3":
                kern["ms_two_tier_fixed_step"] = t_tt["two_tier_fixed_step"]
                kern["ms_two_tier_step"] = t_tt["two_tier_step"]
                kern["max_abs_err_two_tier_stage2"] = err_tt
                kern["max_abs_err_stbsr_ler"] = err_ler
                kern["trace_k3_grids"] = prof["k3_grids"]
            if key == "K4":
                kern["ms_per"] = "decode iteration, all shards"
                kern["k1_ms"] = t["K1_shard_capacity"]
                kern["k1_ms_bench"] = t["K1_shard_bench"]
                kern["max_abs_err_n40000"] = err_k4_big
    if args.quick:  # K3b's regime is not checked with --quick
        kernels = [k for k in kernels if not k["name"].startswith("K3b")]
        for kern in kernels:
            key = kern["name"].split()[0]
            if key in parity_routes:
                kern["routes_parity_phase"] = parity_routes[key]
    for kern in kernels:
        key = kern["name"].split()[0]
        kern["max_abs_err"] = err[key]
        if key in err_dem:
            kern["max_abs_err_dem_dc53"] = err_dem[key]
        if key == "K1" and not args.quick:
            kern["max_abs_err_host_path_matrices"] = err_host_k1
            kern["max_abs_err_dem4"] = err_dem4
        if key in err_wide:
            kern["max_abs_err_wide"] = err_wide[key]
    bg.shutdown()
    if not args.quick:
        log("host path (run_simulation through p_sweep, device sampler) shots/s: "
            + json.dumps({m: round(r, 1) for m, r in host_speed.items()}))
        log("two-tier (bench_two_tier's regime; the flagship point) shots/s: "
            + json.dumps({m: round(r, 1) for m, r in tt_speed.items()}))
        log("bench_gross shots/s by p: " + json.dumps({p: round(r, 1)
                                                       for p, r in gross_speed.items()}))
        log("validate_dem stage seconds: " + json.dumps({k: round(v, 3)
                                                         for k, v in vdem_times.items()}))
        log(f"demo_sliding_window walltime ratio / rounds ratio: {sw_ratio:.4f}")
        log("bench_osd_host host OSD shots/s: " + json.dumps({k: round(v, 1)
                                                              for k, v in osd_speed.items()}))
        log("bench_spacetime ms per batch: " + json.dumps({k: round(v, 4)
                                                           for k, v in st_ms.items()}))
        log(f"bench_scaling decoded shots/s (1 device): {scaling_rate:.1f}")
        log("selection (phase 37) ms by regime: " + json.dumps(
            {r["regime"]: {f"{x['candidate']}/{x['request']}": x["ms"] for x in sel_rows
                           if x["regime"] == r["regime"]} for r in sel_rows if r["auto"]}))
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(f"card: {smi}")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
