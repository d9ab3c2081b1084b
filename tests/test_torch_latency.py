"""The port's latency tables and quickstart §1–2 against the reference.

``repro_torch.core.latency`` builds Table I (and Table II, ``slow`` like
the reference's Table II tests: about 40 s of program generation) from the
port's own plans; every row must equal the reference's field by field. The
last test runs the port's equivalents of ``examples/quickstart.py`` §1–2 —
the 128×16 16-bit matvec, the 256×128 ±1 matvec, Table I and the
4096×2048 tiled ±1 matvec on 20 tiles — and compares outputs and cycle
counts with the reference's: the north star's test that the main path is
ported. Every value is an integer: tolerance 0.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # leave the other test workers their cores

import repro.core as ref_core  # noqa: E402
from repro.core import latency as ref_latency  # noqa: E402
from repro_torch.core import (BinaryConvPlan, BinaryMatvecPlan,  # noqa: E402
                              ConvPlan)
from repro_torch.core import latency  # noqa: E402

slow = pytest.mark.slow


def _rows(rows):
    return [dataclasses.astuple(r) for r in rows]


def test_table1_matches_reference():
    mine, ref = latency.build_table1(), ref_latency.build_table1()
    assert _rows(mine) == _rows(ref)
    assert latency.format_rows(mine, "Table I") == \
        ref_latency.format_rows(ref, "Table I")
    assert latency.TABLE1_PAPER == ref_latency.TABLE1_PAPER
    assert latency.TABLE2_PAPER == ref_latency.TABLE2_PAPER


@slow
def test_table2_matches_reference():
    assert _rows(latency.build_table2()) == _rows(ref_latency.build_table2())


def test_cycle_helpers_match_reference():
    geom = dict(rows=64, cols=256, parts=8)
    plan = BinaryMatvecPlan(64, 64, **geom)
    assert latency.compiled_cycles(plan) == plan.cycles == \
        ref_latency.compiled_cycles(ref_core.BinaryMatvecPlan(64, 64, **geom))
    assert latency.matvec_cycles(128, 16, 16, 2) == \
        ref_latency.matvec_cycles(128, 16, 16, 2)
    assert latency.binary_matvec_cycles(256, 128) == \
        ref_latency.binary_matvec_cycles(256, 128)
    assert latency.naive_binary_matvec_cycles(64, 32) == \
        ref_latency.naive_binary_matvec_cycles(64, 32)
    assert latency.conv_cycles(64, 8, 3, 8) == \
        ref_latency.conv_cycles(64, 8, 3, 8)
    assert latency.binary_conv_cycles(64, 64, 3) == \
        ref_latency.binary_conv_cycles(64, 64, 3)
    assert latency.host_io_cycles(6, 64) == ref_latency.host_io_cycles(6, 64)
    bconv = BinaryConvPlan(16, 32, 3, **geom)
    rbconv = ref_core.BinaryConvPlan(16, 32, 3, **geom)
    K = np.array([[1, -1, 1], [-1, 1, -1], [1, 1, -1]])
    bconv.ensure_program(K)
    rbconv.ensure_program(K)
    assert latency.serialized_cycles(bconv.program) == \
        ref_latency.serialized_cycles(rbconv.program)
    conv = ConvPlan(16, 8, 3, 4, **geom)
    conv.ensure_program(np.ones((3, 3), np.int64))
    assert latency.compiled_cycles(conv) == conv.cycles


def test_quickstart_sections_1_2_match_reference():
    """``examples/quickstart.py`` §1–2 on the port (``device="cpu"``) and on
    the reference, operands from the same seed, at the quickstart's own
    shapes."""
    import repro_torch.core as port

    def section(mod, **run):
        rng = np.random.default_rng(0)
        A = rng.integers(0, 1 << 16, size=(128, 16)).astype(np.int64)
        x = rng.integers(0, 1 << 16, size=16).astype(np.int64)
        y, cycles = mod.matpim_matvec(A, x, N=16, alpha=2, **run)
        Ab = rng.choice([-1, 1], size=(256, 128))
        xb = rng.choice([-1, 1], size=128)
        yb, pop, cyc = mod.matpim_binary_matvec(Ab, xb, **run)
        table = _rows(mod.latency.build_table1())
        At = rng.choice([-1, 1], size=(4096, 2048))
        xt = rng.choice([-1, 1], size=2048)
        yt, info = mod.tiled_binary_matvec(At, xt, **run)
        return {"mv": (y, cycles, A, x), "bmv": (yb, pop, cyc, Ab, xb),
                "table1": table, "tiled": (yt, info, At, xt)}

    mine = section(port, device="cpu")
    want = section(ref_core)

    y, cycles, A, x = mine["mv"]
    np.testing.assert_array_equal(np.asarray(y, dtype=object),
                                  np.asarray(want["mv"][0], dtype=object))
    np.testing.assert_array_equal(
        np.asarray(y, dtype=object),
        (A.astype(object) @ x.astype(object)) % (1 << 32))
    assert cycles == want["mv"][1]

    yb, pop, cyc, Ab, xb = mine["bmv"]
    np.testing.assert_array_equal(yb, want["bmv"][0])
    np.testing.assert_array_equal(pop, want["bmv"][1])
    np.testing.assert_array_equal(
        yb, np.where(((Ab * xb) > 0).sum(1) >= 64, 1, -1))
    assert cyc == want["bmv"][2]

    assert mine["table1"] == want["table1"]

    yt, info, At, xt = mine["tiled"]
    np.testing.assert_array_equal(yt, want["tiled"][0])
    np.testing.assert_array_equal(yt, np.where(At @ xt >= 0, 1, -1))
    ref_info = want["tiled"][1]
    assert (info.grid, info.n_tiles, info.cycles, info.reduce_depth) == \
        (ref_info.grid, ref_info.n_tiles, ref_info.cycles,
         ref_info.reduce_depth) == ((4, 5), 20, 565, 3)
    assert info.backend == "torch"
