"""Port: the launch plan of the flat BP kernels K1 (csrc/bsr_bp.cu) and K5
(csrc/bsr_bp_int8.cu), ``utils/cuda_build.py::bsr_plan``, on the CPU.

The plan is arithmetic on shapes: the padded shot axis, the shot blocks of
the early exit, and each phase's lane width and grid.  Here: every lane
width divides the padded shots and the resolved shot block (no item
straddles two exit blocks, a custom ``shot_block=96`` and ragged S
included), the items of a phase cover rows x shots exactly once (the
kernels' ``RowItems`` walk, thread by thread), the grid stops at its cap,
the main path's widths come out as designed, every width a plan can pick
has a compiled instance in the kernels' dispatch, and ``_block_iters``
turns the kernels' per-block "unconverged" table into iterations.
"""
import re
from pathlib import Path

import pytest
import torch

from exp_ldpc_tpu_torch.decoders.bp_bsr import _block_iters, _blocks
from exp_ldpc_tpu_torch.utils.cuda_build import (MAX_SLOTS, BSR_SHOT_ALIGN, ROW_THREADS,
                                                 bsr_plan, bsr_widths)

torch.set_num_threads(1)
SMS = 132                       # an H100's SM count
CSRC = Path(__file__).resolve().parents[1] / "exp_ldpc_tpu_torch" / "csrc"
# (checks, variables, check degree, variable degree) of the main path's codes
CODES = {"H": (108, 225, 7, 4), "(H|I)": (108, 333, 8, 4), "cyclic": (1540, 4862, 24, 18),
         "hgp40000": (19200, 40000, 7, 4), "qclp": (465, 1054, 8, 5)}


def _items(plan_phase, rows, shots, threads=ROW_THREADS):
    """csrc/vec_io.cuh::RowItems, thread by thread: the (row, first shot)
    items every thread of the grid visits, in its order."""
    sv = shots // plan_phase.vec
    total, stride = rows * sv, plan_phase.blocks * threads
    return [[(i // sv, (i % sv) * plan_phase.vec) for i in range(t, total, stride)]
            for t in range(plan_phase.blocks * threads)]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("shot_block", [96, 128, 256])
@pytest.mark.parametrize("S", [1, 77, 128, 685, 1000, 16384])
def test_widths_divide_shots_and_shot_block(S, shot_block, int8):
    for name, (C, V, dc, dv) in CODES.items():
        sb, G = _blocks(shot_block, S)
        plan = bsr_plan(C, V, dc, dv, S, sb, SMS, int8)
        assert plan.live == S and plan.shot_block == sb
        assert plan.shots % BSR_SHOT_ALIGN == 0 and S <= plan.shots < S + BSR_SHOT_ALIGN
        # the blocks cover the padded axis; the live shots' blocks come first
        assert (plan.groups - 1) * sb < plan.shots <= plan.groups * sb and G <= plan.groups
        for phase, rows in ((plan.checks, C), (plan.variables, V), (plan.parity, C)):
            assert plan.shots % phase.vec == 0 and sb % phase.vec == 0, (name, phase)
            assert phase.items == rows * plan.shots // phase.vec


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("C,S,sb,sms", [(5, 77, 96, 1), (7, 1, 128, 2), (3, 685, 128, 1),
                                        (2, 1000, 100, 1), (40, 96, 96, 1)])
def test_items_cover_rows_and_shots_once(C, S, sb, sms, int8):
    """Every (row, shot) of the padded axis is owned by exactly one item,
    no item straddles two exit blocks, and neighbouring threads take
    neighbouring shot vectors of one row (rows outermost)."""
    plan = bsr_plan(C, 2 * C, 8, 3, S, sb, sms, int8)
    for phase, rows in ((plan.checks, C), (plan.variables, 2 * C), (plan.parity, C)):
        threads = _items(phase, rows, plan.shots)
        owned = [(r, s0 + v) for seen in threads for r, s0 in seen for v in range(phase.vec)]
        assert sorted(owned) == [(r, s) for r in range(rows) for s in range(plan.shots)]
        for seen in threads:
            for _r, s0 in seen:
                assert s0 // sb == (s0 + phase.vec - 1) // sb
        first = [seen[0] for seen in threads if seen]
        assert first == sorted(first)


def test_grid_cap():
    """The grid covers the items once up to 32 blocks per SM; past that a
    thread takes several items."""
    small = bsr_plan(108, 333, 8, 4, 685, 128, SMS)
    assert small.checks.blocks == -(-108 * 688 // 4 // ROW_THREADS)
    big = bsr_plan(19200, 40000, 7, 4, 16384, 256, SMS)
    for phase in big:
        if hasattr(phase, "blocks"):
            assert phase.blocks == 32 * SMS < -(-phase.items // ROW_THREADS)
    with pytest.raises(ValueError):
        bsr_plan(108, 333, 8, 4, 0, 128, SMS)


def test_main_path_widths():
    """Check degree 7 (H), 8 ((H|I)) and 24 (cyclic), at 1,024 shots in
    blocks of 128: K1 4 shots a lane on checks of up to 16 slots and 2
    above, 8 on variables of up to 8 edges and 4 up to 24; K5 16 / 8 on
    checks and variables; 16 on the parity bytes.  A shot block that 4
    does not divide (98) leaves 2 for K1's checks and 1 for K5's."""
    want = {False: {"H": (4, 8), "(H|I)": (4, 8), "cyclic": (2, 4)},
            True: {"H": (16, 16), "(H|I)": (16, 16), "cyclic": (8, 8)}}
    for int8, rows in want.items():
        for name, (va, vb) in rows.items():
            C, V, dc, dv = CODES[name]
            plan = bsr_plan(C, V, dc, dv, 1024, 128, SMS, int8)
            assert (plan.checks.vec, plan.variables.vec, plan.parity.vec) == (va, vb, 16), name
    assert bsr_plan(108, 333, 8, 4, 1024, 98, SMS).checks.vec == 2
    assert bsr_plan(108, 333, 8, 4, 1024, 98, SMS, True).checks.vec == 1


def test_cooperative_route():
    """K1's one-launch route where its instance exists (checks of 7 or 8
    slots, variables of up to 8 edges, widths 4 / 8 / 16) and every phase's
    grid fits two blocks per SM: the host redecode's (H|I) at 685 shots and
    ``bench_bp``'s H at 1,024; not at 16,384 shots, the cyclic code, a shot
    block that forces narrower lanes, for K5, or without ``coop``."""
    def route(name, S, sb=128, int8=False, coop=True):
        C, V, dc, dv = CODES[name]
        plan = bsr_plan(C, V, dc, dv, S, sb, SMS, int8, coop)
        if plan.route == "coop":
            assert max(plan.checks.blocks, plan.variables.blocks, plan.parity.blocks) <= 2 * SMS
        return plan.route

    assert route("(H|I)", 685, 256) == route("(H|I)", 77) == route("H", 1024) == "coop"
    assert route("(H|I)", 1) == "coop"
    assert route("(H|I)", 16384, 256) == route("cyclic", 1024) == route("qclp", 1024) == "grids"
    assert route("(H|I)", 685, 100) == "grids"      # lanes of 4 / 4 / 4
    assert route("(H|I)", 685, int8=True) == route("(H|I)", 685, coop=False) == "grids"


def _instances(source: str):
    """The (check width, lane width) pairs of phase A, the lane widths of its
    route "wide" (``WIDE(vec)``), the (register edges, lane width) pairs of
    phase B and the lane widths of phase C that a kernel file dispatches to."""
    text = (CSRC / source).read_text()
    checks = text[text.index("static bool checks("):text.index("static bool vars(")]
    vars_ = text[text.index("static bool vars("):text.index("static bool parity(")]
    parity = text[text.index("static bool parity("):]
    a = [(int(m), e == "true", int(v))
         for m, e, v in re.findall(r"CASE\((\d+), (true|false), (\d+)\)", checks)]
    wide = [int(v) for v in re.findall(r"WIDE\((\d+)\)", checks)]
    b = [(int(d), int(v)) for d, v in re.findall(r"CASE\((\d+), (\d+)\)", vars_)]
    c = [int(v) for v in re.findall(r"case (\d+):", parity)]
    return a, wide, b, c


@pytest.mark.parametrize("int8,source", [(False, "bsr_bp.cu"), (True, "bsr_bp_int8.cu")])
def test_every_planned_width_is_compiled(int8, source):
    """For every check degree up to 64, variable degree up to 30 and a
    spread of shot blocks, the kernel file has an instance for each width
    the plan picks (the C entry refuses the rest): a register instance up to
    ``MAX_SLOTS`` slots, route "wide" above."""
    inst_a, inst_wide, inst_b, inst_c = _instances(source)
    assert sorted(inst_wide) == ([1, 4, 8, 16] if int8 else [1, 2, 4, 8])
    for dc in range(1, 65):
        for dv in (1, 4, 8, 9, 18, 24, 25, 30):
            for sb in (1, 2, 4, 8, 16, 96, 98, 100, 128, 256):
                plan = bsr_plan(10, 20, dc, dv, 256, sb, SMS, int8)
                va, vb, vc = plan.checks.vec, plan.variables.vec, plan.parity.vec
                assert (plan.route == "wide") == (dc > MAX_SLOTS)
                if plan.route == "wide":
                    assert va in inst_wide
                else:
                    width = next(m for m, exact, v in inst_a
                                 if (dc == m if exact else dc <= m) and v == va)
                    assert width >= dc
                dvr = 8 if dv <= 8 else 24 if dv <= 24 else 0
                assert (dvr, vb) in inst_b, (dc, dv, sb)
                assert vc in inst_c
    for vecs in (bsr_widths(7, 4, int8) + bsr_widths(24, 18, int8) + bsr_widths(32, 30, int8)
                 + bsr_widths(53, 12, int8)):
        assert all(ROW_THREADS % v == 0 and 16 % v == 0 for v in vecs)


@pytest.mark.parametrize("int8", [False, True])
def test_wide_route(int8):
    """Checks of more than 32 slots take route "wide" (K1 and K5; before
    the launch, from the degree alone, whatever ``coop`` asks): at the
    1-round circuit-noise detector model of HGP-225 (216 checks, 1,518
    faults, check degree 53), 97 and 4,096 shots, 16-byte lanes on the
    check phase (K1 8 bf16 shots, K5 16 int8), and the phases' items cover
    rows x shots once.  Degree 32 keeps the register instances."""
    vec = 16 if int8 else 8
    for S, sb in ((97, 128), (4096, 256)):
        plan = bsr_plan(216, 1518, 53, 12, S, sb, SMS, int8, coop=True)
        assert plan.route == "wide" and plan.checks.vec == vec
        assert plan.checks.items == 216 * plan.shots // vec
    assert bsr_plan(216, 1518, 53, 12, 4096, 98, SMS, int8).checks.vec in (1, 2)
    assert bsr_plan(216, 1518, 32, 12, 4096, 256, SMS, int8, coop=True).route == "grids"
    assert bsr_plan(108, 333, 8, 4, 685, 256, SMS, int8, coop=True).route == (
        "grids" if int8 else "coop")


def test_block_iters_per_shot_block():
    """Shot block g ran until the first iteration after which it had no
    unconverged shot: block 0 stops after iteration 1 (1 iteration), block 1
    after 3, block 2 never (the budget), block 3 (padded shots only) after
    1.  Rows past the exit stay zero; the columns past the live shots are
    ignored."""
    max_iter, sb = 5, 4
    gbad = torch.zeros((max_iter, 4), dtype=torch.int32)
    gbad[:2, 1] = 1
    gbad[:, 2] = 1
    iters = _block_iters(gbad, max_iter, sb, 10)
    assert iters.dtype == torch.int32
    assert iters.tolist() == [1] * 4 + [3] * 4 + [5] * 2


def test_bench_bsr_refuses_the_cpu():
    """The K1/K5 timing script measures the card only."""
    from exp_ldpc_tpu_torch.experiments import bench_bsr

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        bench_bsr.main(["--runs", "1"])
