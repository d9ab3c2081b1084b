"""The ``kernels`` backend against the reference's numpy replay.

In the pattern of ``tests/test_pallas_backend.py``: a binary-matvec trace
run on ``backend="kernels"`` must decode to exactly the ``y`` and raw
popcounts a reference numpy replay decodes, with cycles and stats from the
trace; a batch goes through one kernel call; ineligible traces (no spec, or
a fault realization) replay on ``torch`` with the label
``kernels:fallback-torch``. CPU runs use the kernel's plain version; the
``cuda`` test holds the card's kernel path to the torch replay.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # leave the other test workers their cores

from repro_torch.core import (BinaryMatvecPlan, compile_program,  # noqa: E402
                              execute)
from repro_torch.core import kernel_exec as kx  # noqa: E402
from repro_torch.core.isa import ColOp  # noqa: E402
from repro_torch.device.faults import FaultModel, FaultRealization  # noqa
from repro_torch.kernels.binary_matmul import binary_matmul  # noqa: E402

GEOM = dict(rows=64, cols=256, parts=8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _loaded(plan, As, xs):
    mems = np.zeros((len(As), plan.rows, plan.cols), np.uint8)
    for b, (A, x) in enumerate(zip(As, xs)):
        plan.load_into(mems[b], A, x)
    return mems


@pytest.mark.parametrize("m,n,B", [(4, 16, 1), (48, 64, 5), (33, 104, 3)])
def test_binary_matvec_bit_identical_to_reference(m, n, B):
    from repro.core import BinaryMatvecPlan as RefPlan
    from repro.core.engine import execute as ref_execute
    rng = np.random.default_rng(m + n + B)
    As = rng.choice([-1, 1], size=(B, m, n))
    xs = rng.choice([-1, 1], size=(B, n))
    ref = RefPlan(m, n, **GEOM)
    mems = _loaded(ref, As, xs)
    want = ref_execute(ref.compile(), mems, backend="numpy")
    plan = BinaryMatvecPlan(m, n, **GEOM)
    got = plan.execute_batch(mems, backend="kernels", device="cpu")
    assert got.backend == "kernels"
    assert (got.cycles, got.stats) == (want.cycles, want.stats)
    for b in range(B):
        np.testing.assert_array_equal(plan.decode_y(got.mem[b]),
                                      ref.decode_y(want.mem[b]))
        np.testing.assert_array_equal(plan.decode_popcount(got.mem[b]),
                                      ref.decode_popcount(want.mem[b]))
        np.testing.assert_array_equal(plan.decode_y(got.mem[b]),
                                      np.where(As[b] @ xs[b] >= 0, 1, -1))


def test_pack_words_matches_reference():
    from repro.core.pallas_exec import _pack_words as ref_pack
    bits = (np.random.default_rng(2).random((3, 5, 77)) < 0.5).astype(
        np.uint8)
    got = kx._pack_words(torch.from_numpy(bits)).numpy().view(np.uint32)
    want = ref_pack(bits)
    np.testing.assert_array_equal(got, want[..., :got.shape[-1]])
    assert not want[..., got.shape[-1]:].any()   # TPU block padding only


def test_ineligible_traces_fall_back():
    cp = compile_program([[ColOp("NOT", (0,), 1, None)]], 8, 8, 1, 1)
    assert not kx.kernels_eligible(cp)
    res = execute(cp, np.zeros((2, 8, 8), np.uint8), backend="kernels",
                  device="cpu")
    assert res.backend == "kernels:fallback-torch"
    assert res.mem[:, :, 1].all()
    # a fault realization keeps a binary-matvec trace on the replay path
    plan = BinaryMatvecPlan(4, 16, **GEOM)
    cp = plan.compile()
    assert kx.kernels_eligible(cp)
    real = FaultRealization.sample(FaultModel(), 1, 64, 256, cp.n_cycles,
                                   cp.W, cp.I, rng=0)
    rng = np.random.default_rng(3)
    A, x = rng.choice([-1, 1], size=(4, 16)), rng.choice([-1, 1], size=16)
    mems = _loaded(plan, [A], [x])
    res = execute(cp, mems, backend="kernels", device="cpu", faults=real)
    assert res.backend == "kernels:fallback-torch"
    np.testing.assert_array_equal(plan.decode_y(res.mem[0]),
                                  np.where(A @ x >= 0, 1, -1))


def test_cpu_launches_no_kernel():
    before = binary_matmul.launches
    plan = BinaryMatvecPlan(4, 16, **GEOM)
    plan.execute_batch(np.zeros((2, 64, 256), np.uint8), backend="kernels",
                       device="cpu")
    assert binary_matmul.launches == before


@pytest.mark.cuda
def test_cuda_kernels_backend_matches_replay(cuda):
    rng = np.random.default_rng(9)
    plan = BinaryMatvecPlan(48, 64, **GEOM)
    As = rng.choice([-1, 1], size=(33, 48, 64))
    xs = rng.choice([-1, 1], size=(33, 64))
    mems = _loaded(plan, As, xs)
    before = binary_matmul.launches
    got = plan.execute_batch(mems, backend="kernels", device=cuda)
    assert got.backend == "kernels" and binary_matmul.launches == before + 1
    want = plan.execute_batch(mems, backend="torch-fused", device=cuda)
    for b in range(33):
        np.testing.assert_array_equal(plan.decode_y(got.mem[b]),
                                      plan.decode_y(want.mem[b]))
        np.testing.assert_array_equal(plan.decode_popcount(got.mem[b]),
                                      plan.decode_popcount(want.mem[b]))
