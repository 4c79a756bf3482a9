"""Port: the launch plan of the whole-decode kernels K2 (csrc/stbp.cu) and K6
(csrc/bpflat.cu), ``utils/cuda_build.py::resident_plan``, on the CPU.

The plan is pure arithmetic on shapes: the kernels take its numbers (shots
per block, row stride, threads, tables in shared memory, bytes) and check
the bytes against their own layout.  Here: the budget is never exceeded,
the blocks cover every shot once, a few hundred shots spread over every SM,
the shapes whose state does not fit take the streamed route, the per-shot
bytes are the arrays the streamed route allocates, ``walk`` (the
kernels' item loop, ``csrc/resident_bp.cuh``) visits every (row, shot) item
once, and checks of more than 32 slots take route "wide" on either route,
whose instances the kernels' entry points dispatch to.  The streamed route
(``utils/cuda_build.py::streamed_plan``): each grid's grid-stride walk
(``csrc/vec_io.cuh::RowItems``) covers every (row, shot vector) item once,
the lane widths divide the padded shot count, the wrappers' buffers are the
scratch rows ``streamed_scratch`` names, no padded shot reaches an output,
and no item of K2's check grid touches a measurement row another item
writes.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from exp_ldpc_tpu_torch.codes.bivariate_bicycle import gross_code
from exp_ldpc_tpu_torch.codes.hgp import biregular_hgp
from exp_ldpc_tpu_torch.convert import tanner_tables
from exp_ldpc_tpu_torch.decoders import bp_cuda as k6
from exp_ldpc_tpu_torch.decoders import spacetime_bp_cuda as k2
from exp_ldpc_tpu_torch.decoders.spacetime import SpacetimeCode, SpacetimeCodeSingleShot
from exp_ldpc_tpu_torch.decoders.tanner import TannerELL
from exp_ldpc_tpu_torch.utils.cuda_build import (MAX_SLOTS, ROW_THREADS, STREAMED_SHOT_ALIGN,
                                                 ResidentPlan, StreamedPlan,
                                                 resident_max_threads, resident_plan,
                                                 streamed_plan)

torch.set_num_threads(1)
H100 = dict(smem_optin=232448, sm_count=132)   # cudaDevAttrMaxSharedMemoryPerBlockOptin, SMs
CSRC = Path(__file__).resolve().parents[1] / "exp_ldpc_tpu_torch" / "csrc"


def _tables(H):
    return tanner_tables(TannerELL.from_check_matrix(H), "cpu")


@pytest.fixture(scope="module")
def shapes():
    """(name, kernel, per-shot, fixed, table bytes, check width) at the shapes
    of the main path and the over-budget ones."""
    H = biregular_hgp(12, 3, 4, seed=0).checks.z
    out = []
    for name, M, R in (("hgp225 x4", H, 4), ("gross x12", gross_code().checks.z, 12),
                       ("hgp10000 x8", biregular_hgp(80, 3, 4, seed=7).checks.z, 8)):
        t = _tables(M)
        out.append((name, "K2", *k2.resident_bytes(t, R), t.max_check_degree + 2))
    for name, M in (("H", H), ("(H|I)", SpacetimeCodeSingleShot(H).spacetime_check_matrix),
                    ("hgp40000", biregular_hgp(160, 3, 4, seed=0).checks.z)):
        t = _tables(M)
        out.append((name, "K6", *k6.resident_bytes(t), t.max_check_degree))
    return out


def _need(plan: ResidentPlan, per_shot, fixed, table):
    return plan.stride * per_shot + fixed + (table if plan.tables_smem else 0)


@pytest.mark.parametrize("S", [1, 77, 131, 132, 133, 299, 685, 1000, 4096, 16384, 100003])
@pytest.mark.parametrize("tune", [{}, dict(max_group=3), dict(pad=1), dict(threads=300),
                                  dict(blocks_per_sm=4), dict(blocks_per_sm=2, pad=1)])
def test_plan_budget_and_cover(shapes, S, tune):
    for name, _k, per_shot, fixed, table, width in shapes:
        plan = resident_plan(per_shot, table, S, **H100, fixed_bytes=fixed, width=width, **tune)
        if plan is None:   # one shot does not fit: the caller takes the streamed route
            assert (1 + tune.get("pad", 0)) * per_shot + fixed > H100["smem_optin"]
            continue
        cap = resident_max_threads(width)
        # past one wave of one block per SM, blocks_per_sm blocks share an SM
        one_wave = S <= H100["sm_count"] * ((H100["smem_optin"] - fixed - table) // per_shot
                                           - tune.get("pad", 0))
        per_sm = 1 if one_wave else tune.get("blocks_per_sm", 1)
        # the budget: the block's bytes, as the kernel lays them out, fit
        budget = H100["smem_optin"] // per_sm
        assert plan.smem_bytes == _need(plan, per_shot, fixed, table) <= budget
        assert plan.stride == plan.group + tune.get("pad", 0)
        # the blocks cover every shot once: all but the last hold G shots
        assert (plan.blocks - 1) * plan.group < S <= plan.blocks * plan.group
        assert plan.group <= tune.get("max_group", plan.group)
        # a few hundred shots spread over every SM: G <= ceil(S / SMs)
        assert plan.group <= -(-S // H100["sm_count"])
        if S <= H100["sm_count"]:
            assert plan.group == 1 and plan.blocks == S
        assert plan.threads % 32 == 0 and 32 <= plan.threads <= cap
        assert plan.threads == (cap // per_sm if "threads" not in tune else 288)
        # the tables sit in shared memory exactly when they fit beside a shot
        assert plan.tables_smem == ((1 + tune.get("pad", 0)) * per_shot + fixed + table <= budget)


def test_plan_fills_the_budget_at_large_batches(shapes):
    """At 16,384 shots the resident blocks hold as many shots as fit, evened
    out over the waves of one block per SM."""
    want = {"hgp225 x4": 11, "gross x12": 7, "H": 63, "(H|I)": 42}
    for name, _k, per_shot, fixed, table, width in shapes:
        plan = resident_plan(per_shot, table, 16384, **H100, fixed_bytes=fixed, width=width)
        if name in want:
            fit = (H100["smem_optin"] - fixed - table) // per_shot
            waves = -(-16384 // (H100["sm_count"] * fit))
            assert plan.group == -(-16384 // (H100["sm_count"] * waves)) == want[name]
            assert plan.route == "resident" and plan.tables_smem
    # K2's default: four blocks of 256 threads per SM (the sweep's winner)
    by = {s[0]: s for s in shapes}
    for name, group in (("hgp225 x4", 2), ("gross x12", 1)):
        _n, _k, per_shot, fixed, table, width = by[name]
        plan = resident_plan(per_shot, table, 16384, **H100, fixed_bytes=fixed, width=width,
                             blocks_per_sm=k2.BLOCKS_PER_SM)
        assert (plan.group, plan.threads, plan.blocks) == (group, 256, 16384 // group)
        assert 4 * plan.smem_bytes <= H100["smem_optin"]


def test_over_budget_shapes_take_the_streamed_route(shapes, h100_limits):
    """One shot of K2 at the n = 10,000 HGP over 8 rounds (1.56 MB) or of K6
    at the n = 40,000 HGP (557 KB) exceeds the opt-in shared memory: no
    resident plan, and the wrappers' plan is the streamed grids over every
    check and variable row, the shots padded to a multiple of 4."""
    by = {s[0]: s for s in shapes}
    for name in ("hgp10000 x8", "hgp40000"):
        _n, _k, per_shot, fixed, table, width = by[name]
        assert per_shot > H100["smem_optin"]
        assert resident_plan(per_shot, table, 128, **H100, fixed_bytes=fixed, width=width) is None
    cpu = torch.device("cpu")
    t = _tables(biregular_hgp(80, 3, 4, seed=7).checks.z)
    plan = k2.launch_plan(t, 8, 77, cpu)
    r, n = t.num_checks, t.num_vars
    assert isinstance(plan, StreamedPlan) and plan.label == "streamed"
    assert (plan.shots, plan.live, plan.wide) == (80, 77, False)
    assert plan.checks.items == 9 * r * 20 and plan.parity.items == 9 * r * 20
    assert plan.variables.items == (8 * r + 9 * n) * 20
    t = _tables(biregular_hgp(160, 3, 4, seed=0).checks.z)
    plan = k6.launch_plan(t, 685, cpu)
    assert isinstance(plan, StreamedPlan) and (plan.shots, plan.live) == (688, 685)
    assert plan.checks.items == t.num_checks * 172 and plan.variables.items == t.num_vars * 172
    with pytest.raises(ValueError):
        resident_plan(100, 0, 0, **H100)
    with pytest.raises(ValueError):
        streamed_plan(10, 10, 0, 8, 132)


def test_per_shot_bytes_match_the_allocated_arrays():
    """K2's and K6's per-shot bytes are the arrays the streamed wrappers
    allocate per shot (f32 scratch), plus the syndrome bytes and a 4-byte
    flag; fixed bytes are one live-slot mask per (base) check; table bytes
    are the two int32 Tanner tables."""
    H = biregular_hgp(12, 3, 4, seed=0).checks.z
    for M, R in ((H, 4), (gross_code().checks.z, 12), (H, 1)):
        t = _tables(M)
        per_shot, fixed, table = k2.resident_bytes(t, R)
        f32_rows = sum(rows for _n, rows in k2.streamed_scratch(t, R))
        synd_rows = (R + 1) * t.num_checks
        assert per_shot == 4 * f32_rows + synd_rows + 4
        assert fixed == 4 * t.num_checks
        assert table == 4 * (t.chk_vars_k.numel() + t.vm_k.numel())
    for M in (H, SpacetimeCodeSingleShot(H).spacetime_check_matrix):
        t = _tables(M)
        per_shot, fixed, table = k6.resident_bytes(t)
        f32_rows = sum(rows for _n, rows in k6.streamed_scratch(t))
        assert per_shot == 4 * f32_rows + t.num_checks + 4
        assert fixed == 4 * t.num_checks
        assert table == 4 * (t.chk_vars_k.numel() + t.vm_k.numel())


def _walk(H, L, G, T):
    """csrc/resident_bp.cuh::walk, thread by thread: the (hi, lo, shot)
    items each of T threads visits, in its order."""
    threads = []
    for tid in range(T):
        seen = []
        row0, drow = tid // G, T // G
        shot, dshot = tid - row0 * G, T - drow * G
        hi, lo = row0 // L, row0 % L
        dhi, dlo = drow // L, drow % L
        while hi < H:
            seen.append((hi, lo, shot))
            shot, lo, hi = shot + dshot, lo + dlo, hi + dhi
            if shot >= G:
                shot, lo = shot - G, lo + 1
            if lo >= L:
                lo, hi = lo - L, hi + 1
        threads.append(seen)
    return threads


@pytest.mark.parametrize("H,L,G,T", [(5, 108, 11, 1024), (5, 108, 3, 1024), (1, 432, 1, 1024),
                                     (1, 333, 42, 256), (13, 72, 7, 512), (1, 7, 2000, 1024),
                                     (3, 5, 1, 32), (1, 1, 1, 64)])
def test_walk_visits_every_item_once(H, L, G, T):
    threads = _walk(H, L, G, T)
    want = [(h, lo, g) for h in range(H) for lo in range(L) for g in range(G)]
    assert sorted(x for seen in threads for x in seen) == want
    # thread t starts at item t and steps by T: neighbouring threads take
    # neighbouring items (shots innermost, then rows)
    for tid, seen in enumerate(threads):
        flat = [(h * L + lo) * G + g for h, lo, g in seen]
        assert flat == list(range(tid, H * L * G, T))


@pytest.mark.parametrize("module", ["bench_resident", "profile_batch"])
def test_card_only_scripts_refuse_the_cpu(module):
    """The K2/K6 sweep and the batch trace measure the card only."""
    import importlib

    script = importlib.import_module(f"exp_ldpc_tpu_torch.experiments.{module}")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        script.main(["--repeats", "1"])


def test_streamed_bound_counts_the_messages_each_iteration():
    """The device-memory bound of a streamed decode counts its inputs and
    outputs once and, each iteration, the syndromes and tables again and one
    read and one write of every f32 message; the on-chip bound counts the
    inputs and outputs once.  ``bench_resident`` reports both for every
    shape, the streamed shapes of K2 and K6 among them."""
    from exp_ldpc_tpu_torch.experiments import bench_resident as br
    from exp_ldpc_tpu_torch.utils import bounds

    t = _tables(biregular_hgp(12, 3, 4, seed=0).checks.z)
    C, V, Dc, Dv = t.num_checks, t.num_vars, t.max_check_degree, t.max_var_degree
    S, iters, nnz = 100, 48, 3 * V
    io = bounds.flat_io(t, S)
    assert io == C * S + 4 * V + 4 * (C * Dc + V * Dv) + 4 * V * S + 5 * S
    b = bounds.streamed_bound(io, C, t, nnz, S, iters)
    per_iter = C * S + 4 * (C * Dc + V * Dv) + 8 * nnz * S
    assert b["bound_bytes"] == io + iters * per_iter
    assert b["bound_ms"] == max(1e3 * (io + iters * per_iter) / 3.35e12,
                                1e3 * 11 * nnz * S * iters / 67e12)
    assert b["bound_by"] == "bytes"
    on_chip = bounds.bound(io, bounds.OPS_FLOAT * nnz * S * iters)
    assert on_chip["bound_ms"] < b["bound_ms"] and on_chip["bound_by"] == "operations"
    assert bounds.st_io(50, 70, t, S) == 50 * S + 4 * 70 + 4 * (C * Dc + V * Dv) + 4 * 70 * S + 5 * S
    shapes = {(k, name, S) for k, name, _r, S, *_ in br.cases()}
    assert shapes >= {("K6", "hgp_40000", 685), ("K2", "cyclic_lp_4862", 2048),
                      ("K6", "hgp_2880_w18", 685), ("K6", "hgp_4500_w12", 2048)}
    assert set(br._matrices()) >= {name for _k, name, *_ in br.cases()}


def _wide_matrix(rows, cols, lo, hi, seed):
    """Random check matrix with lo..hi ones a row (the last row hi)."""
    from scipy import sparse

    rng = np.random.default_rng(seed)
    w = rng.integers(lo, hi + 1, rows)
    w[-1] = hi
    idx = np.concatenate([rng.choice(cols, k, replace=False) for k in w])
    return sparse.csr_matrix((np.ones(len(idx), np.int64), idx,
                              np.concatenate([[0], np.cumsum(w)])), (rows, cols))


@pytest.fixture
def h100_limits(monkeypatch):
    """The plans read the card's limits through the kernels' library: an
    H100's here."""
    for mod in (k2, k6):
        monkeypatch.setattr(mod, "device_limits",
                            lambda _kern, _dev: (H100["smem_optin"], H100["sm_count"]))


@pytest.mark.parametrize("dc", [29, 30, 31, 32, 33, 40, 53])
@pytest.mark.parametrize("route", ["auto", "streamed"])
def test_wide_route_from_the_degree(h100_limits, dc, route):
    """K2 takes route "wide" exactly past 32 slots of data and measurement
    messages together (Dc > 30), K6 past 32 data slots, on the resident and
    the streamed route alike; the wide resident kernels run 512 threads."""
    t = _tables(_wide_matrix(40, 160, dc - 4, dc, seed=dc))
    assert t.max_check_degree == dc
    cpu = torch.device("cpu")
    for plan, width in ((k2.launch_plan(t, 2, 300, cpu, route=route), dc + 2),
                        (k6.launch_plan(t, 300, cpu, route=route), dc)):
        assert plan.wide == (width > MAX_SLOTS)
        assert plan.route == ("resident" if route == "auto" else "streamed")
        assert plan.label == plan.route + ("_wide" if plan.wide else "")
        if plan.route == "resident":
            assert plan.threads <= resident_max_threads(width)


def test_wide_route_at_the_dense_hgp(h100_limits):
    """biregular_hgp(32, 16, 16): 1,024 checks of degree 32.  Its spacetime
    checks (34 slots) over 4 rounds take K2's streamed route "wide" (655 KB
    a shot); its (H|I) (33 slots, 136 KB a shot: one shot fits a block) K6's
    streamed route "wide" (K6's rule: at most 2 shots of checks of 17 slots
    or more); H alone (32 slots) keeps the register instances."""
    H = biregular_hgp(32, 16, 16, seed=0).checks.z
    cpu = torch.device("cpu")
    t = _tables(H)
    assert t.max_check_degree == 32
    plan = k2.launch_plan(t, 4, 1024, cpu)
    assert (plan.route, plan.wide) == ("streamed", True)
    plan = k6.launch_plan(_tables(SpacetimeCodeSingleShot(H).spacetime_check_matrix), 1024, cpu)
    assert (plan.route, plan.wide, plan.label) == ("streamed", True, "streamed_wide")
    assert not k6.launch_plan(t, 1024, cpu).wide


def test_k6_streams_where_few_shots_of_wide_checks_fit(h100_limits):
    """K6 takes the streamed route where at most 2 shots fit a resident
    block and the checks hold 17 slots or more (the cyclic lifted product
    n = 4,862: 24 slots, 1 shot; a 500 x 2,000 matrix of 46-50 slots: 2
    shots), and stays resident where the checks are narrower (HGP n =
    10,000: 7 slots, 1 shot) or more shots fit (the 60 x 300 matrix of
    33-40 slots: 23 shots; HGP-225's H; the 12-slot probes, 1 and 2 shots;
    the 18- and 20-slot ones stream).  K2's rule is unchanged."""
    from exp_ldpc_tpu_torch.experiments import bench_large_codes as fam

    cpu = torch.device("cpu")
    cases = (("cyclic", fam._cyclic_H(), "streamed"), ("hgp10000", fam._hgp_H(80, 7), "resident"),
             ("two shots", _wide_matrix(500, 2000, 46, 50, seed=3), "streamed"),
             ("60x300", _wide_matrix(60, 300, 33, 40, seed=21), "resident"),
             ("H", biregular_hgp(12, 3, 4, seed=0).checks.z, "resident"))
    # the 12-20 slot probes behind the threshold (bench_select.WIDTH_PROBES): 12 resident
    from exp_ldpc_tpu_torch.experiments.bench_select import width_probes

    cases += tuple((name, M, "resident" if name.endswith("w12") else "streamed")
                   for name, M in width_probes())
    for name, M, route in cases:
        t = _tables(M)
        per_shot, fixed, table = k6.resident_bytes(t)
        fit = (H100["smem_optin"] - fixed - table) // per_shot
        if fit < 1:
            fit = (H100["smem_optin"] - fixed) // per_shot
        assert route == ("streamed" if t.max_check_degree >= k6.STREAMED_MIN_WIDTH and
                         fit <= k6.STREAMED_MAX_FIT else "resident"), name
        assert k6.streams(t, H100["smem_optin"]) == (route == "streamed"), name
        assert k6.streams(TannerELL.from_check_matrix(M), H100["smem_optin"]) == (
            route == "streamed"), name
        for S in (1, 685, 2048):
            assert k6.launch_plan(t, S, cpu).route == route, name
    t = _tables(fam._hgp_H(32, 42))
    assert k2.launch_plan(t, 4, 685, cpu).route == "resident"   # one shot a block, 9 slots


def test_routes_can_be_forced_where_one_shot_fits(h100_limits):
    """``route="resident"`` and ``"streamed"`` force a route (the
    benchmarks time both on the same inputs); the resident route is refused
    where one shot does not fit; the streamed plan reaches the C entry
    points as the check grid's lane width and the three grids' blocks."""
    from exp_ldpc_tpu_torch.experiments import bench_large_codes as fam

    cpu = torch.device("cpu")
    cyc = _tables(fam._cyclic_H())
    assert k6.launch_plan(cyc, 685, cpu).route == "streamed"
    forced = k6.launch_plan(cyc, 685, cpu, route="resident")
    assert (forced.route, forced.group) == ("resident", 1)
    big = _tables(biregular_hgp(160, 3, 4, seed=11).checks.z)
    with pytest.raises(ValueError, match="does not fit"):
        k6.launch_plan(big, 685, cpu, route="resident")
    with pytest.raises(ValueError, match="does not fit"):
        k2.launch_plan(cyc, 4, 685, cpu, route="resident")
    assert k2.launch_plan(_tables(fam._hgp_H(32, 42)), 4, 685, cpu,
                          route="streamed").route == "streamed"
    with pytest.raises(ValueError, match="unknown route"):
        k6.launch_plan(cyc, 685, cpu, route="grids")
    plan = k6.launch_plan(big, 685, cpu)
    assert plan.launch_args == (plan.checks.vec, plan.checks.blocks, plan.variables.blocks,
                                plan.parity.blocks)
    assert plan.variables.vec == plan.parity.vec == 4
    for source, entry in (("bpflat.cu", "bp_fixed"), ("stbp.cu", "stbp_fixed")):
        text = (CSRC / source).read_text()
        sig = text[text.index(f'extern "C" int {entry}('):]
        sig = sig[:sig.index(")")]
        assert re.sub(r"\s+", " ", sig).endswith(
            "int wide, int vec_a, int blocks_a, int blocks_b, int blocks_c, void* stream"), source


@pytest.mark.parametrize("source,width,prefix", [("stbp.cu", "P", "stbp"),
                                                  ("bpflat.cu", "Dc", "bp")])
def test_wide_instances_exist(source, width, prefix):
    """Each entry point refuses a route that does not match the degree and
    dispatches route "wide" to a resident instance and to the streamed
    route's two-pass check grid; the slot limit is the Python plans'."""
    text = (CSRC / source).read_text()
    assert f"if ((wide != 0) != ({width} > MAX_SLOTS)) return (int)cudaErrorInvalidValue;" in text
    assert "if (wide) return go([](auto... a) { return resident<32, false, true>(a...); });" in text
    for method in (0, 1):
        assert (f"{prefix}_streamed_check_wide_kernel<4, {method}><<<blocks, ROW_THREADS, 0, st>>>"
                "(a, alpha, first);") in text
    header = (CSRC / "spacetime_bp.cuh").read_text()
    assert int(re.search(r"#define MAX_SLOTS (\d+)", header).group(1)) == MAX_SLOTS


# ---------------------------------------------------------------------------
# The streamed route
# ---------------------------------------------------------------------------

def _row_items(plan, rows: int, shots: int):
    """csrc/vec_io.cuh::RowItems over the whole grid: thread t takes items
    t, t + blocks*ROW_THREADS, ... below rows * (shots / vec); item i is row
    i // (shots / vec), first shot (i % (shots / vec)) * vec.  Returns the
    (row, first shot) of every item every thread takes."""
    sv = shots // plan.vec
    total = rows * sv
    stride = plan.blocks * ROW_THREADS
    threads = np.arange(min(stride, total))
    items = threads[:, None] + stride * np.arange(-(-total // stride))[None, :]
    items = items[items < total]
    return np.stack([items // sv, (items % sv) * plan.vec], axis=1)


def _streamed_shapes():
    """(name, kernel, plan rows (checks, variables), check width) of the
    streamed route's callers at a cut size: HGP-225 over 4 rounds and over 0
    rounds, the gross code over 12, the 60 x 300 wide matrix over 2 rounds
    and flat, (H|I), the cyclic code's 24-slot checks flat."""
    H = biregular_hgp(12, 3, 4, seed=0).checks.z
    W = _wide_matrix(60, 300, 33, 40, seed=21)
    out = []
    for name, M, R in (("hgp225 x4", H, 4), ("hgp225 x0", H, 0), ("gross x12", gross_code().checks.z, 12),
                       ("wide x2", W, 2)):
        t = _tables(M)
        r, n = t.num_checks, t.num_vars
        out.append((name, "K2", (R + 1) * r, R * r + (R + 1) * n, t.max_check_degree + 2))
    from exp_ldpc_tpu_torch.experiments import bench_large_codes as fam

    for name, M in (("(H|I)", SpacetimeCodeSingleShot(H).spacetime_check_matrix), ("wide", W),
                    ("qclp", fam._qclp_H())):
        t = _tables(M)
        out.append((name, "K6", t.num_checks, t.num_vars, t.max_check_degree))
    return out


@pytest.fixture(scope="module")
def streamed_shapes():
    return _streamed_shapes()


@pytest.mark.parametrize("S", [1, 2, 77, 128, 685, 2048])
@pytest.mark.parametrize("sm_count", [1, 132])
def test_streamed_plan_covers_every_item_once(streamed_shapes, S, sm_count):
    """Each grid of the streamed route (checks, variables, parity) walks
    every (row, shot vector) item of its rows exactly once: every padded
    shot of every row once, in vectors of the plan's lane width that start
    on a multiple of it; the grid holds at least one block and at most 32
    per SM."""
    for name, _k, check_rows, var_rows, width in streamed_shapes:
        plan = streamed_plan(check_rows, var_rows, S, width, sm_count)
        for grid, rows in ((plan.checks, check_rows), (plan.variables, var_rows),
                           (plan.parity, check_rows)):
            assert grid.items == rows * plan.shots // grid.vec
            assert 1 <= grid.blocks <= 32 * sm_count
            got = _row_items(grid, rows, plan.shots)
            assert len(got) == grid.items, name
            assert (got[:, 1] % grid.vec == 0).all() and (got[:, 1] + grid.vec <= plan.shots).all()
            shots = (got[:, :1] * plan.shots + got[:, 1:] + np.arange(grid.vec)).ravel()
            assert np.array_equal(np.sort(shots), np.arange(rows * plan.shots)), name


@pytest.mark.parametrize("S", [1, 3, 4, 77, 685, 5001, 16384])
@pytest.mark.parametrize("width", [3, 8, 9, 16, 17, 26, 32, 33, 42, 435])
def test_streamed_lane_widths_divide_the_padded_shots(S, width):
    """The shot axis is padded to the next multiple of 4; every grid's lane
    width divides it: 4 shots (16-byte f32 accesses) where a check holds up
    to 16 slots or takes route "wide", 1 up to 32 slots; the variable and
    parity grids 4; route "wide" exactly past 32 slots."""
    plan = streamed_plan(100, 250, S, width, 132)
    assert plan.live == S and plan.shots % STREAMED_SHOT_ALIGN == 0
    assert STREAMED_SHOT_ALIGN == 4 and 0 <= plan.shots - S < 4
    for grid in (plan.checks, plan.variables, plan.parity):
        assert plan.shots % grid.vec == 0
    want = 4 if width <= 16 or width > MAX_SLOTS else 1
    assert (plan.checks.vec, plan.variables.vec, plan.parity.vec) == (want, 4, 4)
    assert plan.wide == (width > MAX_SLOTS)
    assert plan.checks.route == ("wide" if plan.wide else "default")
    assert plan.label == ("streamed_wide" if plan.wide else "streamed")


def _hgp225(rounds):
    H = biregular_hgp(12, 3, 4, seed=0).checks.z
    M = SpacetimeCode(H, rounds).spacetime_check_matrix if rounds else H
    return _tables(H), M


@pytest.mark.parametrize("S", [1, 77, 685, 688])
@pytest.mark.parametrize("kernel", ["K2", "K6"])
def test_streamed_buffers_are_the_scratch_rows(h100_limits, kernel, S):
    """The wrappers' buffers of a streamed decode: the scratch arrays
    ``streamed_scratch`` names, each (rows, padded S) f32; the syndromes
    padded with all-zero columns (the caller's tensor itself where it needs
    no padding); the posterior and conv padded S wide."""
    cpu = torch.device("cpu")
    t, M = _hgp225(4 if kernel == "K2" else 0)
    rng = np.random.default_rng(S)
    synd = torch.as_tensor(rng.integers(0, 2, (M.shape[0], S)), dtype=torch.uint8)
    if kernel == "K2":
        plan = k2.launch_plan(t, 4, S, cpu, route="streamed")
        buf = k2.streamed_buffers(t, 4, synd, plan)
        scratch = k2.streamed_scratch(t, 4)
    else:
        plan = k6.launch_plan(t, S, cpu, route="streamed")
        buf = k6.streamed_buffers(t, synd, plan)
        scratch = k6.streamed_scratch(t)
    Sp = plan.shots
    assert set(buf) == {name for name, _rows in scratch} | {"synd", "post", "conv"}
    for name, rows in scratch:
        assert buf[name].shape == (rows, Sp) and buf[name].dtype == torch.float32
    assert buf["post"].shape == (M.shape[1], Sp) and buf["conv"].shape == (Sp,)
    assert buf["synd"].shape == (M.shape[0], Sp) and buf["synd"].dtype == torch.uint8
    assert torch.equal(buf["synd"][:, :S], synd) and not buf["synd"][:, S:].any()
    if Sp == S:
        assert buf["synd"].data_ptr() == synd.data_ptr()


@pytest.mark.parametrize("S", [1, 77, 685])
def test_no_padded_shot_reaches_an_output(S):
    """The padded columns of a decode's posterior and conv (whatever they
    hold) never reach the outputs: hard, posterior, conv and iters are the
    first S shots', S wide, the posterior contiguous."""
    Sp = -(-S // 4) * 4
    rng = np.random.default_rng(S)
    post = torch.as_tensor(rng.standard_normal((50, Sp)), dtype=torch.float32)
    post[:, S:] = float("nan")
    conv = torch.ones(Sp, dtype=torch.uint8)
    conv[S:] = 7
    hard, p, c, it = k6.live_outputs(post, conv, S, 12)
    assert p.shape == (50, S) and p.is_contiguous() and not torch.isnan(p).any()
    assert torch.equal(p, post[:, :S]) and torch.equal(hard, (post[:, :S] <= 0).to(torch.uint8))
    assert torch.equal(c, torch.ones(S, dtype=torch.bool))
    assert it.shape == (S,) and bool((it == 12).all())


@pytest.mark.parametrize("rounds", [0, 1, 4, 12])
def test_k2_check_grid_items_share_no_measurement_row(rounds):
    """In K2's check grid, check q of round block b reads and writes
    mhi[m_{b-1}] (b > 0) and mlo[m_b] (b < R); no two checks touch the same
    row of either array, and every row of both is written (so the first
    iteration needs no initialised measurement messages after it)."""
    r = 108
    hi, lo = [], []
    for q in range((rounds + 1) * r):
        b = q // r
        if b > 0:
            hi.append(q - r)
        if b < rounds:
            lo.append(q)
    assert sorted(hi) == list(range(rounds * r)) and sorted(lo) == list(range(rounds * r))
