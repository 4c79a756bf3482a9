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
whose instances the kernels' entry points dispatch to.
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
from exp_ldpc_tpu_torch.decoders.spacetime import SpacetimeCodeSingleShot
from exp_ldpc_tpu_torch.decoders.tanner import TannerELL
from exp_ldpc_tpu_torch.utils.cuda_build import (MAX_SLOTS, ResidentPlan,
                                                 resident_max_threads, resident_plan)

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
        if plan.route == "streamed":
            assert plan.group == 0 and plan.blocks == -(-S // 32) and plan.threads == 256
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


def test_over_budget_shapes_take_the_streamed_route(shapes):
    """One shot of K2 at the n = 10,000 HGP over 8 rounds (1.56 MB) or of K6
    at the n = 40,000 HGP (557 KB) exceeds the opt-in shared memory; the
    streamed K2 reads its tables through the read-only cache when they do
    not fit (294 KB there)."""
    by = {s[0]: s for s in shapes}
    for name in ("hgp10000 x8", "hgp40000"):
        _n, _k, per_shot, fixed, table, width = by[name]
        assert per_shot > H100["smem_optin"]
        plan = resident_plan(per_shot, table, 128, **H100, fixed_bytes=fixed, width=width)
        assert plan.route == "streamed" and not plan.tables_smem and plan.smem_bytes == 0
    # a small table beside an over-budget shot stays in shared memory
    plan = resident_plan(10**6, 4096, 64, **H100)
    assert plan.route == "streamed" and plan.tables_smem and plan.smem_bytes == 4096
    with pytest.raises(ValueError):
        resident_plan(100, 0, 0, **H100)


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
    a shot); its (H|I) (33 slots, 136 KB a shot) K6's resident route "wide"
    at one shot per block; H alone (32 slots) keeps the register instances."""
    H = biregular_hgp(32, 16, 16, seed=0).checks.z
    cpu = torch.device("cpu")
    t = _tables(H)
    assert t.max_check_degree == 32
    plan = k2.launch_plan(t, 4, 1024, cpu)
    assert (plan.route, plan.wide) == ("streamed", True)
    plan = k6.launch_plan(_tables(SpacetimeCodeSingleShot(H).spacetime_check_matrix), 1024, cpu)
    assert (plan.route, plan.wide, plan.group) == ("resident", True, 1)
    assert not k6.launch_plan(t, 1024, cpu).wide


@pytest.mark.parametrize("source,width", [("stbp.cu", "P"), ("bpflat.cu", "Dc")])
def test_wide_instances_exist(source, width):
    """Each entry point refuses a route that does not match the degree and
    dispatches route "wide" to a resident and a streamed instance; the
    slot limit is the Python plans'."""
    text = (CSRC / source).read_text()
    assert f"if ((wide != 0) != ({width} > MAX_SLOTS)) return (int)cudaErrorInvalidValue;" in text
    assert "if (wide) return go([](auto... a) { return resident<32, false, true>(a...); });" in text
    assert "if (wide) return go([](auto... a) { return streamed<32, true>(a...); });" in text
    header = (CSRC / "spacetime_bp.cuh").read_text()
    assert int(re.search(r"#define MAX_SLOTS (\d+)", header).group(1)) == MAX_SLOTS
