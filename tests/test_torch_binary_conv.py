"""The port's binary conv (§III-C) against the reference.

``BinaryConvPlan`` must compile to the reference's golden trace
(``tests/golden/binary_conv.json``, written by ``tools/gen_golden.py``) and
its runs must equal the reference's at the shapes of
``tests/test_core_algorithms.py``: the same ±1 maps and cycle counts. The
tiled wrapper and the one-shot call give the reference's maps, grid, tiles
and cycles on ``torch`` and on ``kernels`` (which no kernel computes: the
trace replays under ``kernels:fallback-torch``). A ``PlanService`` stream
of binary conv, matvec and conv requests gives the reference service's
tickets and stats. Every value is an integer: tolerance 0.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # leave the other test workers their cores

from repro.core import BinaryConvPlan as RefPlan  # noqa: E402
from repro.core.tiling import TiledConv2d as RefTiledConv  # noqa: E402
from repro.serve.matpim import PlanService as RefService  # noqa: E402
from repro_torch.core import (BinaryConvPlan, TiledConv2d,  # noqa: E402
                              matpim_binary_conv2d, tiled_binary_conv2d)
from repro_torch.serve import PlanService  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

from gen_golden import trace_record  # noqa: E402

GEOM = dict(rows=64, cols=256, parts=8)
slow = pytest.mark.slow


def ref_binary_conv(A, K):
    """sign of the valid ±1 correlation, ties to +1."""
    k = K.shape[0]
    oh, ow = A.shape[0] - k + 1, A.shape[1] - k + 1
    acc = np.zeros((oh, ow), dtype=np.int64)
    for v in range(k):
        for h in range(k):
            acc += A[v:v + oh, h:h + ow] * K[v, h]
    return np.where(acc >= 0, 1, -1)


def test_golden_binary_conv_trace():
    plan = BinaryConvPlan(32, 32, 3, **GEOM)
    plan.ensure_program(np.random.default_rng(99).choice([-1, 1],
                                                         size=(3, 3)))
    golden = json.loads((ROOT / "tests" / "golden" / "binary_conv.json")
                        .read_text())
    assert trace_record(plan) == golden


@pytest.mark.parametrize("m,n,k", [(64, 64, 3),
                                   pytest.param(128, 128, 3, marks=slow),
                                   (128, 64, 5)])
def test_binary_conv_matches_reference(m, n, k):
    rng = np.random.default_rng(m + n)
    A = rng.choice([-1, 1], size=(m, n))
    K = rng.choice([-1, 1], size=(k, k))
    out_ref, cycles_ref = RefPlan(m, n, k).run(A, K)
    plan = BinaryConvPlan(m, n, k)
    out, cycles = plan.run(A, K, device="cpu")
    np.testing.assert_array_equal(out, out_ref)
    np.testing.assert_array_equal(out, ref_binary_conv(A, K))
    assert cycles == cycles_ref == plan.cycles
    assert plan.ctr_w == RefPlan(m, n, k).ctr_w == (6 if k == 5 else 5)


@settings(max_examples=8, deadline=None)
@given(st.integers(0, 2 ** 9 - 1))
def test_binary_conv_kernel_property(kmask):
    """Any 3x3 ±1 kernel gives the reference's map (the taps are baked into
    the gates, so every kernel is its own program)."""
    K = np.where([[(kmask >> (3 * v + h)) & 1 for h in range(3)]
                  for v in range(3)], 1, -1)
    A = np.random.default_rng(kmask).choice([-1, 1], size=(64, 64))
    out, cycles = BinaryConvPlan(64, 64, 3).run(A, K, device="cpu")
    out_ref, cycles_ref = RefPlan(64, 64, 3).run(A, K)
    np.testing.assert_array_equal(out, out_ref)
    assert cycles == cycles_ref


def test_program_follows_the_kernel():
    """``ensure_program`` rebuilds when K changes; ``cycles`` builds with
    an all-ones kernel when no program exists; ``kernels`` falls back."""
    plan = BinaryConvPlan(8, 32, 3, **GEOM)
    ref = RefPlan(8, 32, 3, **GEOM)
    assert plan.cycles == ref.cycles and plan.K is None
    K = -np.ones((3, 3), dtype=int)
    prog = plan.ensure_program(K)
    assert plan.ensure_program(K.copy()) is prog
    assert plan.ensure_program(-K) is not prog
    A = np.random.default_rng(3).choice([-1, 1], size=(8, 32))
    out, cycles = matpim_binary_conv2d(A, K, backend="kernels",
                                       device="cpu", **GEOM)
    out_ref, cycles_ref = RefPlan(8, 32, 3, **GEOM).run(A, K)
    np.testing.assert_array_equal(out, out_ref)
    assert cycles == cycles_ref
    mem = np.zeros((2, 64, 256), np.uint8)
    for b in range(2):
        plan.load_into(mem[b], A, K)
    plan.ensure_program(K)
    res = plan.execute_batch(mem, backend="kernels", device="cpu")
    assert res.backend == "kernels:fallback-torch"
    np.testing.assert_array_equal(plan.decode_out(res.mem[1]), out_ref)


def _info(info):
    return (info.grid, info.n_tiles, info.cycles, info.reduce_depth)


@pytest.mark.parametrize("H,W,k,tile_m,backend", [
    (20, 40, 3, 12, "torch"),         # neither side a multiple of the tile
    (26, 64, 3, 16, "kernels"),       # width a multiple of the tile
    (14, 35, 5, 10, "torch")])        # 5×5 taps (6-bit counters)
def test_tiled_binary_conv_matches_reference(H, W, k, tile_m, backend):
    rng = np.random.default_rng(H * W + k)
    A = rng.choice([-1, 1], size=(H, W))
    K = rng.choice([-1, 1], size=(k, k))
    ref = RefTiledConv(H, W, k, 1, binary=True, tile_m=tile_m, tile_n=32,
                       **GEOM)
    out_ref, info_ref = ref.run(A, K, backend="numpy")
    t = TiledConv2d(H, W, k, 1, binary=True, tile_m=tile_m, tile_n=32,
                    **GEOM)
    out, info = t.run(A, K, backend=backend, device="cpu")
    np.testing.assert_array_equal(out, out_ref)
    np.testing.assert_array_equal(out, ref_binary_conv(A, K))
    assert out.dtype == out_ref.dtype == np.int64
    assert _info(info) == _info(info_ref)
    assert info.backend == ("kernels:fallback-torch" if backend == "kernels"
                            else backend)
    # the one-shot call: run-time kwargs split from the plan's, tile_n 64
    # unless given
    out2, info2 = tiled_binary_conv2d(A, K, tile_m=tile_m, backend=backend,
                                      device="cpu", **GEOM)
    from repro.core.tiling import tiled_binary_conv2d as ref_one_shot
    out2_ref, info2_ref = ref_one_shot(A, K, tile_m=tile_m, **GEOM)
    np.testing.assert_array_equal(out2, out2_ref)
    assert _info(info2) == _info(info2_ref)


def _stream(seed):
    """Binary conv (two kernels, one shared by two requests), matvec and
    conv requests, shuffled."""
    rng = np.random.default_rng(seed)
    K1 = rng.choice([-1, 1], size=(3, 3))
    K2 = rng.choice([-1, 1], size=(3, 3))
    reqs = [("binary_conv", (rng.choice([-1, 1], size=(12, 30)), K1)),
            ("binary_conv", (rng.choice([-1, 1], size=(9, 20)), K1)),
            ("binary_conv", (rng.choice([-1, 1], size=(16, 40)), K2)),
            ("matvec", (rng.integers(0, 16, size=(6, 20)),
                        rng.integers(0, 16, size=20), 4)),
            ("conv", (rng.integers(0, 16, size=(10, 9)),
                      rng.integers(0, 16, size=(3, 3)), 4)),
            ("binary_matvec", (rng.choice([-1, 1], size=(7, 30)),
                               rng.choice([-1, 1], size=30)))]
    return [reqs[i] for i in rng.permutation(len(reqs))]


STATS = ("hits", "misses", "evictions", "requests", "batches", "units")


@pytest.mark.parametrize("backend", ["kernels", "torch"])
def test_stream_with_binary_conv_matches_reference(backend):
    reqs = _stream(4)
    ref = RefService(store=False, **GEOM)
    ref_t = [ref.submit(kind, *args) for kind, args in reqs]
    ref.flush()
    svc = PlanService(backend=backend, device="cpu", **GEOM)
    mine = [svc.submit(kind, *args) for kind, args in reqs]
    svc.flush()
    for t, r, (kind, args) in zip(mine, ref_t, reqs):
        np.testing.assert_array_equal(t.result, r.result)
        assert (t.kind, t.key[:-1], t.cycles, t.reduce_depth, t.n_units,
                t.batch_units) == (r.kind, r.key[:-1], r.cycles,
                                   r.reduce_depth, r.n_units, r.batch_units)
        if kind == "binary_conv":
            np.testing.assert_array_equal(t.result, ref_binary_conv(*args))
            assert t.backend == ("kernels:fallback-torch"
                                 if backend == "kernels" else backend)
    for f in STATS:
        assert getattr(svc.stats, f) == getattr(ref.stats, f), f
    # one kernel shares a plan and a batch; distinct kernels two plans
    by_kernel = {}
    for t, (kind, args) in zip(mine, reqs):
        if kind == "binary_conv":
            by_kernel.setdefault(args[1].tobytes(), []).append(t)
    shared, alone = sorted(by_kernel.values(), key=len, reverse=True)
    assert len(shared) == 2 and shared[0].key == shared[1].key
    assert shared[0].batch_units == shared[0].n_units + shared[1].n_units
    assert len(alone) == 1 and alone[0].key != shared[0].key
