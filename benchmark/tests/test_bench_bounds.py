"""The benchmark's frozen copy of the bounds gives the program's
``utils/bounds.py`` numbers at the cells' shapes."""
import numpy as np
import pytest
from scipy import sparse

from benchmark import bounds as frozen
from benchmark.reference.codes import bivariate_bicycle, read_qecc, spacetime_matrix
from benchmark.tests.conftest_paths import CONFIGS
from benchmark.harness import decode_mode
from benchmark.work import Tab
from exp_ldpc_tpu_torch.decoders.tanner import TannerELL
from exp_ldpc_tpu_torch.utils import bounds as program

HZ = read_qecc(CONFIGS / "hgp225.qecc")["hz"]
GROSS = bivariate_bicycle(12, 6, [(3, 0), (0, 1), (0, 2)], [(0, 3), (1, 0), (2, 0)])[1]


def test_constants():
    assert (frozen.HBM_BYTES_PER_S, frozen.OPS_PER_S, frozen.OPS_FLOAT) == \
        (program.HBM_BYTES_PER_S, program.OPS_PER_S, program.OPS_FLOAT)


@pytest.mark.parametrize("h, rounds, shots, iters", [(HZ, 4, 16384, 48), (GROSS, 12, 20000, 60)])
def test_spacetime_stage(h, rounds, shots, iters):
    tab = TannerELL.from_check_matrix(sparse.csr_matrix(h))
    st = spacetime_matrix(h, rounds)
    assert frozen.table_bytes(Tab(h)) == program.table_bytes(tab)
    io = frozen.st_io(*st.shape, Tab(h), shots)
    assert io == program.st_io(*st.shape, tab, shots)
    ops = frozen.OPS_FLOAT * int(st.sum()) * shots * iters
    assert frozen.bound(io, ops) == program.bound(io, ops)
    assert decode_mode({"mode": "bp"}).bound_ms(h, rounds, shots, iters) == \
        pytest.approx(program.bound(io, ops)["bound_ms"], rel=1e-12)


def test_flat_stages_and_modes():
    hi = np.hstack([HZ, np.eye(HZ.shape[0], dtype=HZ.dtype)])
    parts = {}
    for key, m in (("H", HZ), ("HI", hi)):
        tab = TannerELL.from_check_matrix(sparse.csr_matrix(m))
        assert frozen.flat_io(Tab(m), 16384) == program.flat_io(tab, 16384)
        parts[key] = program.bound(program.flat_io(tab, 16384),
                                   program.OPS_FLOAT * int(m.sum()) * 16384 * 48)["bound_ms"]
    def mode(name):
        return decode_mode({"mode": name}).bound_ms(HZ, 4, 16384, 48)

    st = mode("bposd")
    assert st == pytest.approx(0.5996, abs=5e-5)          # PERF.md's K2 bound, 0.600 ms
    assert mode("bposd_hybrid") == pytest.approx(st + parts["H"], rel=1e-12)
    assert mode("bposd_single_shot") == pytest.approx(4 * parts["HI"] + parts["H"], rel=1e-12)
