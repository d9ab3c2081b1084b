"""The port's host-side compile against the reference.

``repro_torch.core.compile`` must lower programs to byte-identical traces:
the golden fixture of ``tests/golden/binary_matvec.json`` (written from the
reference by ``tools/gen_golden.py``) must match the port's
``BinaryMatvecPlan`` in every field, random programs must compile to equal
arrays and schedules, and the state I/O must round-trip both ways with the
reference's ``compiled_state``. Exact comparisons throughout.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # leave the other test workers their cores

from test_conformance import random_program  # noqa: E402
from test_torch_engine import port_program  # noqa: E402

from repro.core import compile_program as ref_compile  # noqa: E402
from repro.core.compile import compiled_from_state as ref_from  # noqa: E402
from repro.core.compile import compiled_state as ref_state  # noqa: E402
from repro_torch.core import (BinaryMatvecPlan, Crossbar,  # noqa: E402
                              NaiveBinaryMatvecPlan, compile_program,
                              compiled_from_state, compiled_state)

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

from gen_golden import trace_record  # noqa: E402

ARRAYS = ("mode", "nops", "gate", "dst", "ins", "sel", "init_r", "init_c",
          "init_v", "row_masks", "col_masks")


def test_golden_binary_matvec_trace():
    want = json.loads((ROOT / "tests" / "golden" /
                       "binary_matvec.json").read_text())
    plan = BinaryMatvecPlan(48, 64, rows=64, cols=256, parts=8)
    assert trace_record(plan) == want


def test_binary_matvec_interpreter_matches_reference():
    """Port plan on the port interpreter == reference plan on the
    reference interpreter: memory, cycles, stats, decoded outputs."""
    from repro.core import BinaryMatvecPlan as RefPlan
    rng = np.random.default_rng(4)
    A = rng.choice([-1, 1], size=(48, 64))
    x = rng.choice([-1, 1], size=64)
    ref = RefPlan(48, 64, rows=64, cols=256, parts=8)
    mine = BinaryMatvecPlan(48, 64, rows=64, cols=256, parts=8)
    want = ref.run_program(lambda m: ref.load_into(m, A, x),
                           ref.new_crossbar())
    got = mine.run_program(lambda m: mine.load_into(m, A, x), Crossbar(
        64, 256, 8, 8))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    np.testing.assert_array_equal(mine.decode_y(got[0]),
                                  np.where(A @ x >= 0, 1, -1))
    np.testing.assert_array_equal(mine.decode_popcount(got[0]),
                                  ref.decode_popcount(want[0]))


@pytest.mark.parametrize("seed", (1, 5, 9, 17))
def test_random_programs_compile_identically(seed):
    prog, rows, cols, parts = random_program(seed)
    want = ref_compile(prog, rows, cols, parts, parts)
    got = compile_program(port_program(prog), rows, cols, parts, parts)
    for name in ARRAYS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert (got.n_cycles, got.W, got.I, got.stats) == \
        (want.n_cycles, want.W, want.I, want.stats)
    assert got.schedule.summary() == want.schedule.summary()
    for s, r in zip(got.schedule.segments, want.schedule.segments):
        assert (s.mode, s.t0, s.t1, s.W, s.spans) == \
            (r.mode, r.t0, r.t1, r.W, r.spans)
        for f in ("nops", "gate", "dst", "ins", "sel", "perm"):
            np.testing.assert_array_equal(getattr(s, f), getattr(r, f))


def test_state_round_trips_with_reference():
    """Reference state → port trace and port state → reference trace."""
    plan = BinaryMatvecPlan(16, 64, rows=64, cols=256, parts=8)
    meta, arrays = compiled_state(plan.compile())
    back = ref_from(meta, arrays)
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(back, name),
                                      getattr(plan.compile(), name))
    from repro.core import BinaryMatvecPlan as RefPlan
    rmeta, rarrays = ref_state(RefPlan(16, 64, rows=64, cols=256,
                                       parts=8).compile())
    assert rmeta == meta
    cp = compiled_from_state(rmeta, rarrays)
    assert cp.schedule.summary() == plan.compile().schedule.summary()
    with pytest.raises(ValueError):
        compiled_from_state(dict(rmeta, state_schema=99), rarrays)


def test_naive_plan_matches_reference_cycles():
    from repro.core.binary_matvec import NaiveBinaryMatvecPlan as RefNaive
    rng = np.random.default_rng(8)
    A = rng.choice([-1, 1], size=(8, 16))
    x = rng.choice([-1, 1], size=16)
    mine = NaiveBinaryMatvecPlan(8, 16, rows=64, cols=256, parts=8)
    y, cycles = mine.run(A, x, device="cpu")
    ref_y, ref_cycles = RefNaive(8, 16, rows=64, cols=256, parts=8).run(A, x)
    np.testing.assert_array_equal(y, ref_y)
    assert cycles == ref_cycles
